"""The optional LPIPS perceptual metric.

Counterpart of ``seganygaussians_tpu/utils/lpips_metric.py``: LPIPS needs
the ``lpips`` package and its pretrained backbone weights, which ship with
neither package, so the metric is import-guarded and reports itself
unavailable without them.  ``net`` is a seam for tests: any module taking
two (1, 3, H, W) images in [-1, 1] and returning the distance.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def lpips_available() -> bool:
    try:
        import lpips as _  # noqa: F401
    except ImportError:
        return False
    return True


def load_net(net_type: str = "alex", device="cuda") -> torch.nn.Module:
    """The ``lpips`` package's network (its backbone weights included) on
    ``device``; raises ImportError without the package."""
    if not lpips_available():
        raise ImportError(
            "LPIPS needs the `lpips` package and its backbone weights, an optional "
            "evaluation dependency"
        )
    import lpips as lpips_pkg

    return lpips_pkg.LPIPS(net=net_type, verbose=False).eval().to(device)


def lpips(img0, img1, net_type: str = "alex", net: Optional[torch.nn.Module] = None) -> float:
    """LPIPS distance between two (H, W, 3) images in [0, 1] (tensors on any
    device, or numpy arrays), on the first image's device, through ``net``
    (else a network :func:`load_net` loads for this call).  Raises
    ImportError without the ``lpips`` package unless ``net`` is given:
    callers check :func:`lpips_available`."""

    def to_nchw(a):
        x = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a, np.float32))
        return x.float().permute(2, 0, 1)[None] * 2.0 - 1.0

    x0 = to_nchw(img0)
    x1 = to_nchw(img1).to(x0.device)
    if net is None:
        net = load_net(net_type, x0.device)
    with torch.no_grad():
        return float(net(x0, x1).reshape(()))
