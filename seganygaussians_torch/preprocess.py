"""Offline preprocessing: per-SAM-mask 3D scale extraction.

Counterpart of ``seganygaussians_tpu/preprocess.py``: render expected depth,
back-project every pixel to camera-space 3D, erode each upsampled mask with a
3×3 ≥ 5 box test, and define the mask's 3D scale as ‖2·std(points in mask)‖.
All masks go through one pair of masked-moment products (std is unbiased,
matching torch's default).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from seganygaussians_torch.utils.precision import ieee_fp32_matmul


def backproject_depth(depth: torch.Tensor, fovx: float, fovy: float) -> torch.Tensor:
    """(H, W) depth → (H, W, 3) camera-space points."""
    h, w = depth.shape
    cx, cy = w / 2.0, h / 2.0
    fx = cx / np.tan(fovx / 2.0)
    fy = cy / np.tan(fovy / 2.0)
    xs = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :]
    ys = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None]
    px = (xs - cx) * depth / fx
    py = (ys - cy) * depth / fy
    return torch.stack([px, py, depth], dim=-1)


def box_sum_3x3(x: torch.Tensor) -> torch.Tensor:
    """Sum over each pixel's 3×3 window of (..., H, W), zero past the border
    (``lax.reduce_window(..., add, (1, 3, 3), (1, 1, 1), "SAME")``): nine
    shifted adds in fp32, and no convolution whose precision a backend flag
    could lower."""
    h, w = x.shape[-2:]
    padded = F.pad(x, (1, 1, 1, 1))
    return sum(padded[..., dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3))


def erode_masks(masks: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bilinear-upsample (K, h, w) masks to ``size`` (half-pixel centres, no
    antialiasing), then 3×3 box-erode with the reference's ≥ 5 threshold."""
    up = F.interpolate(masks.to(torch.float32)[:, None], size=tuple(size), mode="bilinear",
                       align_corners=False, antialias=False)[:, 0]
    return box_sum_3x3(up) >= 5.0


def masked_point_scales(points: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """(K,) ‖2·std of points under each mask‖ with unbiased std, all masks at
    once.

    The two moment products run in IEEE fp32 whatever the caller's TF32
    setting: ``var = E[x²] − mean²`` cancels, and with TF32's 10 mantissa
    bits nothing of a small mask's spread would be left."""
    k = masks.shape[0]
    m = masks.reshape(k, -1).to(torch.float32)  # (K, P)
    p = points.reshape(-1, 3)  # (P, 3)
    n = torch.sum(m, dim=1, keepdim=True)  # (K, 1)
    with ieee_fp32_matmul():
        mean = torch.matmul(m, p) / n.clamp_min(1.0)  # (K, 3)
        ex2 = torch.matmul(m, p * p) / n.clamp_min(1.0)
    var = (ex2 - mean * mean) * (n / (n - 1.0).clamp_min(1.0))
    std = torch.sqrt(var.clamp_min(0.0))
    return torch.linalg.norm(2.0 * std, dim=-1)


def compute_mask_scales(camera, state, sam_masks, config=None) -> torch.Tensor:
    """Full per-view pipeline: depth render → back-project → erode → scales.
    ``camera`` is a ``data.cameras.Camera``; the result lies on the state's
    device."""
    from seganygaussians_torch import render as R
    from seganygaussians_torch.ops.rasterize import RasterConfig

    config = config or RasterConfig()
    device = state.params.xyz.device
    with torch.no_grad():
        pkg = R.render_with_depth(camera.params, state, torch.zeros(3, device=device),
                                  config=config)
        if pkg["overflow"]:
            raise RuntimeError(
                f"instance capacity {config.capacity} exceeded on view {camera.image_name}; "
                "raise --raster_capacity"
            )
        depth = pkg["depth"]
        points = backproject_depth(depth, camera.fovx, camera.fovy)
        eroded = erode_masks(torch.as_tensor(np.asarray(sam_masks), device=device),
                             tuple(depth.shape))
        return masked_point_scales(points, eroded)
