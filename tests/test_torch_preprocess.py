"""Port parity for preprocess.py (per-SAM-mask 3D scales).

Seeded numpy depth maps and masks go through the JAX package and the port.
Back-projection agrees to 1e-6 relative; the eroded masks are the same
booleans (bilinear up-sampling of {0, 1} masks gives small dyadic sums, and
the ≥ 5 threshold of the 3×3 box sits between attainable values); the mask
scales agree to 5e-5 relative: ``var = E[x²] − mean²`` in float32 cancels
about two digits at these depths, and the two packages sum in another order
(both are held to a float64 reference at that tolerance as well).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from seganygaussians_tpu import preprocess as jpre
from seganygaussians_torch import preprocess as tpre

H, W = 96, 128


def seeded_masks(k=6, h=30, w=40, seed=2):
    """Discs and boxes of mixed size, one single pixel and one empty mask."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[:h, :w]
    masks = []
    for i in range(k):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(3, 12)
        if i % 2:
            masks.append((abs(ys - cy) < r) & (abs(xs - cx) < 0.7 * r))
        else:
            masks.append((ys - cy) ** 2 + (xs - cx) ** 2 < r * r)
    one = np.zeros((h, w), bool)
    one[h // 2, w // 2] = True
    masks += [one, np.zeros((h, w), bool)]
    return np.stack(masks)


def seeded_depth(seed=3):
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[:H, :W]
    return (3.0 + 0.01 * xs + 0.02 * ys + 0.1 * rng.normal(size=(H, W))).astype(np.float32)


def test_backproject_depth_matches_jax():
    depth = seeded_depth()
    want = np.asarray(jpre.backproject_depth(jnp.asarray(depth), 1.1, 0.85))
    got = tpre.backproject_depth(torch.from_numpy(depth), 1.1, 0.85).numpy()
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("size", [(60, 80), (99, 132)], ids=["2x", "3.3x"])
def test_erode_masks_exact(size):
    masks = seeded_masks()
    want = np.asarray(jpre.erode_masks(jnp.asarray(masks), size))
    got = tpre.erode_masks(torch.from_numpy(masks), size).numpy()
    assert got.dtype == bool and got.shape == (len(masks),) + size
    assert want[:-2].any() and not got[-1].any()
    np.testing.assert_array_equal(got, want)


def test_masked_point_scales_matches_jax():
    points = np.asarray(jpre.backproject_depth(jnp.asarray(seeded_depth()), 1.1, 0.85))
    masks = np.array(jpre.erode_masks(jnp.asarray(seeded_masks()), (H, W)))
    masks[-2] = False
    masks[-2, H // 2, W // 2] = True  # exactly one pixel: std of one point is 0
    want = np.asarray(jpre.masked_point_scales(jnp.asarray(points), jnp.asarray(masks)))
    got = tpre.masked_point_scales(torch.from_numpy(points), torch.from_numpy(masks)).numpy()
    assert got.shape == (len(masks),) and np.isfinite(got).all()
    assert got[-1] == 0.0 and want[-1] == 0.0  # empty mask
    # one pixel: the true std is 0; what is left is the cancellation's noise,
    # sqrt(eps·x²) ≈ 1e-3 at depth 4, in either package
    assert got[-2] < 2e-3 and want[-2] < 2e-3
    assert (got[:-2] > 0.5).all()
    np.testing.assert_allclose(got[:-2], want[:-2], rtol=5e-5, atol=0)
    p64 = points.reshape(-1, 3).astype(np.float64)
    exact = [np.linalg.norm(2.0 * p64[m.reshape(-1)].std(axis=0, ddof=1)) for m in masks[:-2]]
    np.testing.assert_allclose(got[:-2], exact, rtol=5e-5, atol=0)


def test_masked_point_scales_turns_tf32_off_itself(monkeypatch):
    """The moment products run with TF32 off even when the caller left it on
    (var = E[x²] − mean² cancels), and the caller's setting comes back."""
    seen = []
    matmul = torch.matmul

    def spy(*args, **kwargs):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return matmul(*args, **kwargs)

    monkeypatch.setattr(tpre.torch, "matmul", spy)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        points = torch.from_numpy(np.random.default_rng(1).normal(size=(8, 8, 3)).astype(np.float32))
        tpre.masked_point_scales(points, torch.ones(2, 8, 8, dtype=torch.bool))
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert len(seen) == 2 and not any(seen)
