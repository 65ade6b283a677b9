"""Quaternion / covariance transforms for Gaussian primitives.

Counterpart of ``seganygaussians_tpu/ops/transforms.py``.  All functions are
batched over the leading axis and differentiable by autograd.
"""

from __future__ import annotations

import torch


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


def build_rotation(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) → rotation matrix, normalising first.

    q: (N, 4) → (N, 3, 3)
    """
    r, x, y, z = q.unbind(-1)
    # Σq² summed left to right, as the preprocess kernel sums it.
    norm = torch.sqrt(((r * r + x * x) + y * y) + z * z)
    r, x, y, z = r / norm, x / norm, y / norm, z / norm
    R = torch.stack(
        [
            1 - 2 * (y * y + z * z),
            2 * (x * y - r * z),
            2 * (x * z + r * y),
            2 * (x * y + r * z),
            1 - 2 * (x * x + z * z),
            2 * (y * z - r * x),
            2 * (x * z - r * y),
            2 * (y * z + r * x),
            1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return R.reshape(q.shape[:-1] + (3, 3))


def build_scaling_rotation(s: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """L = R @ diag(s); covariance = L Lᵀ."""
    return build_rotation(q) * s[..., None, :]


def build_covariance_3d(
    scales: torch.Tensor, rotations: torch.Tensor, scale_modifier: float = 1.0
) -> torch.Tensor:
    """Packed symmetric 3D covariance (xx, xy, xz, yy, yz, zz), (N, 6).

    The 3×3 products are written out elementwise so they stay in full fp32
    whatever the card's matmul precision setting, and summed left to right,
    as the preprocess kernel sums them.
    """
    L = build_scaling_rotation(scale_modifier * scales, rotations)
    sigma = L[..., :, None, 0] * L[..., None, :, 0]
    for k in (1, 2):
        sigma = sigma + L[..., :, None, k] * L[..., None, :, k]
    return strip_symmetric(sigma)


def strip_symmetric(sym: torch.Tensor) -> torch.Tensor:
    """(N,3,3) symmetric → packed (N,6) upper triangle (xx,xy,xz,yy,yz,zz)."""
    return torch.stack(
        [
            sym[..., 0, 0],
            sym[..., 0, 1],
            sym[..., 0, 2],
            sym[..., 1, 1],
            sym[..., 1, 2],
            sym[..., 2, 2],
        ],
        dim=-1,
    )


def unpack_symmetric(packed: torch.Tensor) -> torch.Tensor:
    """Packed (N, 6) (xx, xy, xz, yy, yz, zz) → full symmetric (N, 3, 3)."""
    xx, xy, xz, yy, yz, zz = packed.unbind(-1)
    return torch.stack([
        torch.stack([xx, xy, xz], dim=-1),
        torch.stack([xy, yy, yz], dim=-1),
        torch.stack([xz, yz, zz], dim=-1),
    ], dim=-2)
