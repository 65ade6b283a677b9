"""Real spherical harmonics evaluation, degrees 0..4 (PlenOctree basis).

Counterpart of ``seganygaussians_tpu/ops/sh.py``: the same constants and
polynomial layout.  ``eval_sh_color`` applies the +0.5 shift and the
non-negativity clamp of the reference preprocess.
"""

from __future__ import annotations

import torch

from seganygaussians_torch.utils import tracing

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
SH_C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Evaluate the SH basis.

    Args:
      deg: degree in [0, 4].
      sh: [..., C, (deg+1)**2] coefficients.
      dirs: [..., 3] unit directions.
    Returns:
      [..., C]
    """
    if not 0 <= deg <= 4:
        raise ValueError(f"SH degree {deg} outside [0, 4]")
    result = SH_C0 * sh[..., 0]
    if deg > 0:
        x = dirs[..., 0:1]
        y = dirs[..., 1:2]
        z = dirs[..., 2:3]
        result = result - SH_C1 * y * sh[..., 1] + SH_C1 * z * sh[..., 2] - SH_C1 * x * sh[..., 3]
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (
                result
                + SH_C2[0] * xy * sh[..., 4]
                + SH_C2[1] * yz * sh[..., 5]
                + SH_C2[2] * (2.0 * zz - xx - yy) * sh[..., 6]
                + SH_C2[3] * xz * sh[..., 7]
                + SH_C2[4] * (xx - yy) * sh[..., 8]
            )
            if deg > 2:
                result = (
                    result
                    + SH_C3[0] * y * (3.0 * xx - yy) * sh[..., 9]
                    + SH_C3[1] * xy * z * sh[..., 10]
                    + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 11]
                    + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[..., 12]
                    + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 13]
                    + SH_C3[5] * z * (xx - yy) * sh[..., 14]
                    + SH_C3[6] * x * (xx - 3.0 * yy) * sh[..., 15]
                )
                if deg > 3:
                    result = (
                        result
                        + SH_C4[0] * xy * (xx - yy) * sh[..., 16]
                        + SH_C4[1] * yz * (3.0 * xx - yy) * sh[..., 17]
                        + SH_C4[2] * xy * (7.0 * zz - 1.0) * sh[..., 18]
                        + SH_C4[3] * yz * (7.0 * zz - 3.0) * sh[..., 19]
                        + SH_C4[4] * (zz * (35.0 * zz - 30.0) + 3.0) * sh[..., 20]
                        + SH_C4[5] * xz * (7.0 * zz - 3.0) * sh[..., 21]
                        + SH_C4[6] * (xx - yy) * (7.0 * zz - 1.0) * sh[..., 22]
                        + SH_C4[7] * xz * (xx - 3.0 * yy) * sh[..., 23]
                        + SH_C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)) * sh[..., 24]
                    )
    return result


def eval_sh_color(
    deg: int, sh: torch.Tensor, means3d: torch.Tensor, cam_center: torch.Tensor
) -> torch.Tensor:
    """Per-Gaussian view-dependent color: SH along the normalised view
    direction, shifted by +0.5 and clamped at zero."""
    with tracing.span("preprocess"):
        dirs = means3d - cam_center[None, :]
        x, y, z = dirs.unbind(-1)
        # The norm summed left to right, as the preprocess kernel sums it;
        # at 0 its gradient is 0 (as linalg.norm's), not sqrt's infinite one.
        ss = (x * x + y * y) + z * z
        norm = torch.where(ss > 0, torch.sqrt(torch.where(ss > 0, ss, 1.0)), 0.0)
        dirs = dirs / norm.clamp_min(1e-12)[..., None]
        return torch.clamp_min(eval_sh(deg, sh, dirs) + 0.5, 0.0)


def rgb2sh(rgb: torch.Tensor) -> torch.Tensor:
    return (rgb - 0.5) / SH_C0


def sh2rgb(sh: torch.Tensor) -> torch.Tensor:
    return sh * SH_C0 + 0.5
