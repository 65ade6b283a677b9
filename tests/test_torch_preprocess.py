"""Port parity for preprocess.py (per-SAM-mask 3D scales).

Seeded numpy depth maps and masks go through the JAX package and the port.
Back-projection agrees to 1e-6 relative; the eroded masks are the same
booleans (bilinear up-sampling of {0, 1} masks gives small dyadic sums, and
the ≥ 5 threshold of the 3×3 box sits between attainable values); the mask
scales agree to 5e-5 relative: ``var = E[x²] − mean²`` in float32 cancels
about two digits at these depths, and the two packages sum in another order
(both are held to a float64 reference at that tolerance as well).

Also the preprocess kernel pair's plain counterparts (``ops/preprocess_cuda.py``):
``preprocess_backward_plain``, the backward kernel's arithmetic, is held to
autograd through the plain path (``ops/projection.py``, ``ops/sh.py``) in
float64 on seeded scenes with every edge case of that gradient
(``tests/preprocess_scenes.py``), to 1e-9 of each column's largest value and
with the same exact zeros; and the autograd Function around the kernels runs
here with the kernels replaced by their plain counterparts.
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


# --------------------------------------------------------------------------
# The preprocess kernel pair's plain counterparts
# --------------------------------------------------------------------------

from seganygaussians_torch.ops import preprocess_cuda  # noqa: E402
from seganygaussians_torch.ops import projection  # noqa: E402
from seganygaussians_torch.ops.sh import eval_sh_color  # noqa: E402
from preprocess_scenes import cotangents, scene  # noqa: E402

GEOMETRY = ("means3d", "scales", "rotations", "cov3d_precomp", "shs")
PREPROCESS_CASES = [("rotated", d) for d in range(5)] + [("axis", 3), ("cov3d", 2), ("det0", 1),
                                                    ("sliced", 2)]


def plain_outputs(camera, inputs):
    """(means2d, depths, conics, colors) through the plain path, differentiable."""
    prep = projection.preprocess(
        inputs["means3d"], camera, scales=inputs.get("scales"),
        rotations=inputs.get("rotations"), cov3d_precomp=inputs.get("cov3d_precomp"),
        active_mask=inputs["active_mask"], opacities=inputs["opacities"],
        shs=inputs["shs"], sh_degree=inputs["sh_degree"])
    return prep.means2d, prep.depths, prep.conics, prep.colors


def with_leaves(inputs):
    leaves = {k: inputs[k].detach().requires_grad_(True) for k in GEOMETRY if k in inputs}
    return dict(inputs, **leaves), leaves


def assert_grads_match(got, want, tol):
    """Within ``tol`` of each column's largest |value|, and zero exactly where
    ``want`` is."""
    for name in want:
        g, w = got[name].reshape(len(want[name]), -1), want[name].reshape(len(want[name]), -1)
        scale = w.abs().amax(dim=0) + 1e-300
        err = ((g - w).abs() / scale).max().item()
        assert err <= tol, f"{name}: {err:.3g} of the column's largest value"
        assert torch.equal(g == 0, w == 0), f"{name}: exact zeros differ"


@pytest.mark.parametrize("case, sh_degree", PREPROCESS_CASES,
                         ids=[f"{c}-deg{d}" for c, d in PREPROCESS_CASES])
def test_backward_plain_is_autograd_through_the_plain_path(case, sh_degree):
    camera, inputs, live = scene(11, case, sh_degree)
    full, leaves = with_leaves(inputs)
    outs = plain_outputs(camera, full)
    g = cotangents(11, len(live), 3, live)
    want = dict(zip(leaves, torch.autograd.grad(outs, list(leaves.values()), g)))
    got = dict(zip(GEOMETRY, preprocess_cuda.preprocess_backward_plain(
        inputs["means3d"], camera, inputs.get("scales"), inputs.get("rotations"),
        inputs.get("cov3d_precomp"), inputs["shs"], sh_degree, 1.0, *g)))
    assert_grads_match(got, want, 1e-9)
    # The scene holds what it is meant to: culled rows (their gradient
    # exactly 0), clamped directions, clamped colors, det = 0.
    means2d, depths, conics, colors = (o.detach() for o in outs)
    assert (want["means3d"][~live] == 0).all() and (want["means3d"][live] != 0).all()
    view = camera.world_view.astype(np.float64)
    p_view = inputs["means3d"].numpy() @ view[:3, :3] + view[3, :3]
    ratio = np.abs(p_view[:, 0] / p_view[:, 2])
    assert ((ratio > 1.3 * camera.tan_fovx) & live.numpy()).any()
    assert ((colors == 0).any(dim=1) & live).any()
    if case == "det0":
        assert conics[0, 1] == 0 and conics[0, 2] == 0 and live[0]
    if case == "axis":
        assert depths[0] == 0 and depths[1] == 0


class StandIn:
    """A kernel object whose call runs a plain counterpart; it counts its
    launches and keeps its arguments."""

    def __init__(self, fn):
        self.fn, self.launches, self.calls = fn, 0, []

    def __call__(self, *args, **kwargs):
        self.launches += 1
        self.calls.append(args)
        return self.fn(*args, **kwargs)


def forward_plain(means3d, camera, scales, rotations, cov3d, opacities, active_mask, shs,
                  sh_degree, scale_modifier, tile_size):
    with torch.no_grad():
        prep = projection._preprocess_plain(means3d, camera, scales, rotations, cov3d,
                                            scale_modifier, tile_size, active_mask, opacities)
        colors = None
        if shs is not None:
            colors = eval_sh_color(sh_degree, shs, means3d, camera.tensors(means3d.device)[2])
    return (prep.means2d, prep.depths, prep.conics, colors, prep.radii, prep.rect_min,
            prep.rect_max, prep.tiles_touched, prep.valid)


def backward_plain(means3d, camera, scales, rotations, cov3d, shs, sh_degree, scale_modifier,
                   g_means2d, g_depths, g_conics, g_colors, needs):
    grads = preprocess_cuda.preprocess_backward_plain(
        means3d, camera, scales, rotations, cov3d, shs, sh_degree, scale_modifier,
        g_means2d, g_depths, g_conics, g_colors)
    return tuple(g if need else None for g, need in zip(grads, needs))


@pytest.fixture
def stand_ins(monkeypatch):
    fwd, bwd = StandIn(forward_plain), StandIn(backward_plain)
    monkeypatch.setattr(preprocess_cuda, "FORWARD", fwd)
    monkeypatch.setattr(preprocess_cuda, "BACKWARD", bwd)
    return fwd, bwd


def fused(camera, inputs):
    return preprocess_cuda.preprocess_fused(
        inputs["means3d"], camera, inputs.get("scales"), inputs.get("rotations"),
        inputs.get("cov3d_precomp"), 1.0, 16, inputs["active_mask"], inputs["opacities"],
        inputs["shs"], inputs["sh_degree"])


@pytest.mark.parametrize("case", ["rotated", "cov3d"])
def test_fused_function_gives_the_plain_path_and_its_gradient(stand_ins, case):
    """The autograd Function round the kernels, with the kernels replaced by
    their plain counterparts: the plain path's outputs and autograd's
    gradients; only the wanted gradients asked for, and one node between
    the outputs and the leaves."""
    fwd, bwd = stand_ins
    camera, inputs, live = scene(5, case, 3, dtype=torch.float32)
    full, leaves = with_leaves(inputs)
    out = fused(camera, full)
    want = plain_outputs(camera, full)
    for got, ref in zip(out[:4], want):  # float32, its sums vectorised another way
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    for got, ref in zip(out[4:], fwd.fn(*fwd.calls[0])[4:]):
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert [type(o.grad_fn).__name__ for o in out[:4]] == ["_PreprocessBackward"] * 4
    assert all(o.grad_fn is None for o in out[4:])
    g = cotangents(5, len(live), 3, live, dtype=torch.float32)
    names = list(leaves)
    got = dict(zip(names, torch.autograd.grad(out[:4], list(leaves.values()), g)))
    ref = dict(zip(names, torch.autograd.grad(want, list(leaves.values()), g)))
    assert_grads_match(got, ref, 1e-5)
    assert (fwd.launches, bwd.launches) == (1, 1)
    # Only the positions need a gradient: only theirs is computed.
    means_only = dict(inputs, means3d=leaves["means3d"])
    out = fused(camera, means_only)
    (d_means,) = torch.autograd.grad(out[:4], [leaves["means3d"]], g)
    assert bwd.calls[-1][-1] == (True, False, False, False, False)
    torch.testing.assert_close(d_means, ref["means3d"], rtol=0, atol=1e-5 * ref["means3d"].abs().max())


def test_fused_without_gradients_runs_the_forward_alone(stand_ins):
    """Frozen geometry (the feature and serving paths): the forward kernel
    alone, no autograd node, nothing saved."""
    fwd, bwd = stand_ins
    camera, inputs, _ = scene(6, "rotated", 0, dtype=torch.float32)
    out = fused(camera, inputs)
    assert all(o is None or o.grad_fn is None for o in out)
    with_grad, _ = with_leaves(inputs)
    with torch.no_grad():
        out = fused(camera, with_grad)
    assert all(o is None or o.grad_fn is None for o in out)
    assert (fwd.launches, bwd.launches) == (2, 0)


def test_kernel_wrappers_refuse_what_the_kernels_cannot_run():
    camera, inputs, _ = scene(1, "rotated", 3, n=40, dtype=torch.float32)
    fwd = preprocess_cuda.FORWARD
    with pytest.raises(ValueError, match="not CUDA"):
        fwd(inputs["means3d"], camera, inputs["scales"], inputs["rotations"])
    with pytest.raises(ValueError, match="outside"):
        preprocess_cuda._sh_layout(inputs["shs"], 5, 40)
    with pytest.raises(ValueError, match="shs shape"):
        preprocess_cuda._sh_layout(inputs["shs"][:, :, :4], 3, 40)
    with pytest.raises(TypeError):
        preprocess_cuda._sh_layout(inputs["shs"].double(), 3, 40)
    assert preprocess_cuda._sh_layout(inputs["shs"], 3, 40) == (3, 3, 16)
    assert preprocess_cuda._sh_layout(None, 3, 40) == (-1, 0, 0)
    assert len(preprocess_cuda.camera_block(camera, 16, 1.0)) == preprocess_cuda.CAMERA_FLOATS


@pytest.mark.parametrize("layout", ["C", "F"])
def test_plain_path_sums_left_to_right_whatever_the_camera_layout(layout):
    """The plain path's small sums run left to right, the order the kernels
    follow, whatever the camera matrices' memory layout."""
    import dataclasses

    camera, inputs, _ = scene(8, "rotated", 3, n=500, dtype=torch.float32)
    laid = dataclasses.replace(
        camera, world_view=np.asarray(camera.world_view, np.float32, order=layout),
        full_proj=np.asarray(camera.full_proj, np.float32, order=layout))
    args = (inputs["means3d"], inputs["scales"], inputs["rotations"], None, 1.0, 16,
            inputs["active_mask"], inputs["opacities"])
    ref = projection._preprocess_plain(args[0], camera, *args[1:])
    got = projection._preprocess_plain(args[0], laid, *args[1:])
    for a, b in zip(got[:8], ref[:8]):
        assert torch.equal(a, b)
    x, y, z = inputs["means3d"].unbind(-1)
    v = torch.tensor(np.asarray(camera.world_view, np.float32)).reshape(-1)
    assert torch.equal(got.depths, ((x * v[2] + y * v[6]) + z * v[10]) + v[14])
