"""Data-parallel and tile-sharded steps on ``torch.distributed``."""

from seganygaussians_torch.parallel.mesh import make_mesh  # noqa: F401
