"""Port parity for ops/losses.py: l1, mse, psnr, ssim and the gradient of ssim.

Seeded numpy images go through both packages on the CPU.  Values agree to
1e-6 relative (float32 reductions in another order); the SSIM gradient to
1e-4 of its largest entry.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from seganygaussians_tpu.ops import losses as jlosses
from seganygaussians_torch.ops import losses as tlosses


@pytest.fixture
def images():
    rng = np.random.default_rng(11)
    a = rng.uniform(size=(37, 45, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0.0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("name", ["l1_loss", "mse", "psnr", "ssim"])
def test_loss_values_match_jax(images, name):
    a, b = images
    want = float(getattr(jlosses, name)(jnp.asarray(a), jnp.asarray(b)))
    got = float(getattr(tlosses, name)(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_gaussian_window_matches_jax():
    # float32 exp differs by an ulp between the two libraries.
    np.testing.assert_allclose(tlosses._gaussian_window(11).numpy(),
                               np.asarray(jlosses._gaussian_window(11)), rtol=1e-6)


def test_ssim_gradient_matches_jax(images):
    a, b = images
    want = np.asarray(jax.grad(jlosses.ssim)(jnp.asarray(a), jnp.asarray(b)))
    x = torch.from_numpy(a).requires_grad_(True)
    tlosses.ssim(x, torch.from_numpy(b)).backward()
    scale = np.abs(want).max()
    np.testing.assert_allclose(x.grad.numpy() / scale, want / scale, atol=1e-4)


def test_ssim_blur_turns_tf32_off_itself(images, monkeypatch):
    """The blur's convolutions run with cuDNN TF32 off even when the caller
    left it on (the TF32 rounding breaks SSIM's variance terms on the card)."""
    seen = []
    conv2d = tlosses.F.conv2d

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(tlosses.F, "conv2d", spy)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        tlosses.ssim(*(torch.from_numpy(x) for x in images))
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = before
    assert seen and not any(seen)
