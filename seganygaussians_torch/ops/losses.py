"""Image losses: L1, windowed SSIM, PSNR, MSE.

Counterpart of ``seganygaussians_tpu/ops/losses.py``: channels-last on
(H, W, C), SSIM with an 11-tap Gaussian window (σ = 1.5, C1 = 0.01²,
C2 = 0.03²).  The window blur is a grouped ``F.conv2d``.

SSIM's variance terms ``blur(img²) − mu²`` cancel, so the blur must run in
full fp32.  On the card cuDNN rounds fp32 convolution inputs to TF32 by
default (``torch.backends.cudnn.allow_tf32`` is True), which is the same
failure the JAX package fixed on the TPU with ``precision=HIGHEST``.
:func:`_depthwise_blur` therefore turns TF32 off itself, whatever the
caller's global settings are.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - gt))


def mse(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-image MSE → 20·log10(1/√mse)."""
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse(pred, gt)))


def _gaussian_window(window_size: int = 11, sigma: float = 1.5, device=None) -> torch.Tensor:
    x = torch.arange(window_size, dtype=torch.float32, device=device) - window_size // 2
    g = torch.exp(-(x**2) / (2.0 * sigma**2))
    return g / torch.sum(g)


def _depthwise_blur(img: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Separable depthwise 2D blur of (H, W, C) with SAME (zero) padding."""
    c = img.shape[-1]
    k = window.shape[0]
    x = img.permute(2, 0, 1)[None]  # (1, C, H, W)
    kh = window.reshape(1, 1, k, 1).expand(c, 1, k, 1)
    kw = window.reshape(1, 1, 1, k).expand(c, 1, 1, k)
    with torch.backends.cudnn.flags(allow_tf32=False):
        x = F.conv2d(x, kh, padding=(k // 2, 0), groups=c)
        x = F.conv2d(x, kw, padding=(0, k // 2), groups=c)
    return x[0].permute(1, 2, 0)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM of two (H, W, C) images in [0, 1]."""
    window = _gaussian_window(window_size, device=img1.device)
    mu1 = _depthwise_blur(img1, window)
    mu2 = _depthwise_blur(img2, window)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise_blur(img1 * img1, window) - mu1_sq
    sigma2_sq = _depthwise_blur(img2 * img2, window) - mu2_sq
    sigma12 = _depthwise_blur(img1 * img2, window) - mu1_mu2
    c1, c2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return torch.mean(ssim_map)
