"""Plain PyTorch reference of a 3DGS training step: render, L1 + SSIM, the
gradient of every stored parameter, and Adam (3DGS's learning rates, eps
1e-15, bias-corrected).  The SSIM window is the 11 × 11 Gaussian (σ = 1.5)
of the 3DGS code, one 2D convolution per map with zero padding."""

from __future__ import annotations

import math

import torch

from perfbench.reference import render as rr
from perfbench.reference.arith import Arith

LEAVES = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-15


def ssim(img1: torch.Tensor, img2: torch.Tensor, ar: Arith, size: int = 11) -> torch.Tensor:
    """Mean SSIM of two (H, W, C) images."""
    x = torch.arange(size, dtype=torch.float32, device=img1.device) - size // 2
    g = torch.exp(-(x * x) / (2 * 1.5 ** 2))
    g = g / g.sum()
    c = img1.shape[-1]
    window = (g[:, None] * g[None, :]).expand(c, 1, size, size).contiguous()

    def blur(im):
        return ar.conv2d(im.permute(2, 0, 1)[None], window, padding=size // 2, groups=c)

    mu1, mu2 = blur(img1), blur(img2)
    s11 = blur(img1 * img1) - mu1 * mu1
    s22 = blur(img2 * img2) - mu2 * mu2
    s12 = blur(img1 * img2) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))
    return m.mean()


def image_loss(image, gt, ar: Arith, lambda_dssim: float = 0.2):
    l1 = torch.mean(torch.abs(image - gt))
    return (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - ssim(image, gt, ar))


def position_lr(step: int, spatial_lr_scale: float, init=0.00016, final=0.0000016,
                max_steps=30_000) -> float:
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(init * spatial_lr_scale) * (1 - t)
                    + math.log(final * spatial_lr_scale) * t)


def learning_rates(step: int, spatial_lr_scale: float) -> dict:
    return {"xyz": position_lr(step, spatial_lr_scale), "features_dc": 0.0025,
            "features_rest": 0.0025 / 20.0, "scaling": 0.005, "rotation": 0.001,
            "opacity": 0.05}


def adam(params: dict, grads: dict, moments: dict, count: int, lrs: dict):
    """One step; ``moments`` maps a leaf to (m, v).  Returns new params and moments."""
    b1, b2 = BETAS
    t = count + 1
    new_p, new_m = {}, {}
    for k, g in grads.items():
        m, v = moments[k]
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        step = (m / (1 - b1 ** t)) / (torch.sqrt(v / (1 - b2 ** t)) + ADAM_EPS)
        new_p[k] = params[k] - lrs[k] * step
        new_m[k] = (m, v)
    return new_p, new_m


def loss_and_grads(params: dict, cam: rr.Camera, gt, ar: Arith, sh_degree: int = 3):
    """(loss, {leaf: gradient}, the frame) of one view."""
    leaves = {k: params[k].detach().requires_grad_(True) for k in LEAVES}
    with torch.enable_grad():
        frame, (bins, inputs, bg) = rr.render(rr.activate(leaves), cam, ar, sh_degree)
        image = frame.image.detach().requires_grad_(True)
        loss = image_loss(image, gt, ar)
        (g_image,) = torch.autograd.grad(loss, image)
    g_inputs = rr.blend_backward(bins, *inputs, bg, g_image)
    with torch.enable_grad():
        grads = torch.autograd.grad(inputs, [leaves[k] for k in LEAVES], g_inputs,
                                    allow_unused=True)
    grads = {k: torch.zeros_like(leaves[k]) if g is None else g for k, g in zip(LEAVES, grads)}
    return float(loss.detach()), grads, frame
