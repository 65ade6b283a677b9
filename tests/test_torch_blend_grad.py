"""Port parity for the blend's gradient: the backward kernel's plain version.

``blend_cuda.blend_backward_plain`` (autograd through ``ops/blend.py``) is the
function ``csrc/blend_bwd.cu`` computes; ``tests/test_torch_cuda.py`` holds
the kernel against it on the card.  Here, on the CPU, it is held against the
JAX package: ``jax.vjp`` of ``blend_pallas.blend_fused`` (the Pallas
``_bwd_kernel`` in interpret mode, then ``segment_reduce_by_rank``) and of
the XLA ``blend.py``; and the port's ``rasterize`` gradients against JAX
``rasterize(backend="xla")``.  Tolerance: 2e-4 of each column's largest
absolute value, the bound the JAX package holds Pallas against XLA to
(tests/test_blend_pallas.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from seganygaussians_tpu.ops import blend as jblend
from seganygaussians_tpu.ops import blend_pallas
from seganygaussians_tpu.ops.binning import expand_slots as jexpand_slots
from seganygaussians_tpu.ops.projection import preprocess as jpreprocess
from seganygaussians_tpu.ops.rasterize import RasterConfig as JRasterConfig
from seganygaussians_tpu.ops.rasterize import rasterize as jrasterize
from seganygaussians_torch.ops import blend_cuda
from seganygaussians_torch.ops.binning import sort_instances
from seganygaussians_torch.ops.rasterize import RasterConfig, rasterize
from tests.test_rasterize import make_scene
from tests.test_torch_blend import _binned_inputs
from tests.test_torch_geometry import t, torch_camera


def assert_cols_close(got, want, name, tol=2e-4):
    """Each column within ``tol`` of that column's largest |want|."""
    got = np.asarray(got, np.float64).reshape(len(want), -1)
    want = np.asarray(want, np.float64).reshape(len(want), -1)
    scale = np.abs(want).max(axis=0) + 1e-6
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, err_msg=name)


def cotangents(seed, num_tiles, p, c):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(num_tiles, p, c)).astype(np.float32),
            rng.normal(size=(num_tiles, p)).astype(np.float32))


def _pallas_inputs(rng, c, n=60, width=48, height=32):
    camera, means, scales, quats, opac, colors = make_scene(rng, n=n, c=c, width=width,
                                                            height=height)
    ts = 16
    grid = ((width + ts - 1) // ts, (height + ts - 1) // ts, ts)
    prep = jpreprocess(jnp.asarray(means), camera, scales=jnp.asarray(scales),
                       rotations=jnp.asarray(quats), opacities=jnp.asarray(opac))
    plan = jexpand_slots(prep, grid[0], grid[1], 1 << 12)
    perm = np.asarray(plan.depth_perm)
    table = np.concatenate([np.asarray(prep.means2d)[perm], np.asarray(prep.conics)[perm],
                            opac[perm][:, None], colors[perm]], axis=1)
    return plan, table.astype(np.float32), grid


@pytest.mark.parametrize("c", [3, 32])
def test_plain_backward_matches_pallas_bwd_kernel(rng, c):
    plan, table, grid = _pallas_inputs(rng, c)
    bg = np.linspace(0.1, 0.9, c).astype(np.float32)
    g_tiles, g_final_t = cotangents(c, grid[0] * grid[1], grid[2] ** 2, c)

    def loss(fields, bg_):
        out = blend_pallas.blend_fused(plan.slot_rank, plan.slot_tile, fields, bg_, *grid)
        return jnp.sum(out.tiles * g_tiles) + jnp.sum(out.final_t * g_final_t)

    fields = tuple(jnp.asarray(table[:, i]) for i in range(table.shape[1]))
    d_fields, d_bg = jax.jit(jax.grad(loss, argnums=(0, 1)))(fields, jnp.asarray(bg))
    want = np.stack([np.asarray(d) for d in d_fields], axis=1)

    n = table.shape[0]
    gauss_s, _, starts = sort_instances(t(plan.slot_rank).long(), t(plan.slot_tile).long(),
                                        n, grid[0] * grid[1])
    got, got_bg = blend_cuda.blend_backward_plain(gauss_s, starts, t(table), t(bg),
                                                  t(g_tiles), t(g_final_t), grid)
    assert got.shape == (n, 6 + c)
    assert np.abs(want[:, :6]).max(axis=0).min() > 0  # every geometry column is live
    assert_cols_close(got, want, "d_table")
    assert_cols_close(got_bg[None], np.asarray(d_bg)[None], "d_bg")


@pytest.mark.parametrize("c", [3, 32])
def test_plain_backward_matches_xla_blend(rng, c):
    a, grid = _binned_inputs(rng, c)
    g_tiles, g_final_t = cotangents(c + 1, grid[0] * grid[1], grid[2] ** 2, c)
    keys = ("means2d", "conics", "opacities", "colors", "bg")

    def loss(*args):
        out = jblend.blend(jnp.asarray(a["gauss_id"]), jnp.asarray(a["tile_id"]),
                           jnp.asarray(a["tile_starts"]), *args, *grid)
        return jnp.sum(out.tiles * g_tiles) + jnp.sum(out.final_t * g_final_t)

    grads = jax.jit(jax.grad(loss, argnums=tuple(range(5))))(*(jnp.asarray(a[k]) for k in keys))
    want = np.concatenate([np.asarray(grads[0]), np.asarray(grads[1]),
                           np.asarray(grads[2])[:, None], np.asarray(grads[3])], axis=1)
    table = np.concatenate([a["means2d"], a["conics"], a["opacities"][:, None], a["colors"]],
                           axis=1)
    got, got_bg = blend_cuda.blend_backward_plain(
        t(a["gauss_id"]).long(), t(a["tile_starts"]), t(table), t(a["bg"]),
        t(g_tiles), t(g_final_t), grid)
    assert_cols_close(got, want, "d_table")
    assert_cols_close(got_bg[None], np.asarray(grads[4])[None], "d_bg")


def test_plain_backward_takes_none_as_zeros(rng):
    a, grid = _binned_inputs(rng, 3)
    table = t(np.concatenate([a["means2d"], a["conics"], a["opacities"][:, None],
                              a["colors"]], axis=1))
    args = (t(a["gauss_id"]).long(), t(a["tile_starts"]), table, t(a["bg"]))
    g_tiles, g_final_t = (t(x) for x in cotangents(5, grid[0] * grid[1], grid[2] ** 2, 3))
    both = blend_cuda.blend_backward_plain(*args, g_tiles, g_final_t, grid)
    only_t = blend_cuda.blend_backward_plain(*args, g_tiles, None, grid)
    only_f = blend_cuda.blend_backward_plain(*args, None, g_final_t, grid)
    none = blend_cuda.blend_backward_plain(*args, None, None, grid)
    torch.testing.assert_close(only_t[0] + only_f[0], both[0], atol=1e-5, rtol=1e-5)
    assert torch.equal(only_f[1], torch.zeros(3))
    assert not none[0].any() and not none[1].any()


@pytest.mark.parametrize("c", [3, 32])
def test_rasterize_gradients_match_jax(rng, c):
    camera, means, scales, quats, opac, colors = make_scene(rng, n=40, c=c)
    bg = np.linspace(0.2, 0.7, c).astype(np.float32)
    target = np.random.default_rng(3).uniform(size=(32, 48, c)).astype(np.float32)

    def jloss(m, s, o, col, off, b):
        out = jrasterize(m, o, camera, colors=col, scales=s, rotations=jnp.asarray(quats),
                         bg=b, ndc_offset=off,
                         config=JRasterConfig(capacity=1 << 13, backend="xla"))
        return jnp.sum((out.color - target) ** 2) + 0.1 * jnp.sum(out.final_t)

    arrays = (means, scales, opac, colors, np.zeros((40, 2), np.float32), bg)
    g_j = jax.jit(jax.grad(jloss, argnums=tuple(range(6))))(*(jnp.asarray(x) for x in arrays))

    targs = [t(x).requires_grad_(True) for x in arrays]
    out = rasterize(targs[0], targs[2], torch_camera(camera), colors=targs[3],
                    scales=targs[1], rotations=t(quats), bg=targs[5], ndc_offset=targs[4],
                    config=RasterConfig(capacity=1 << 13))
    loss = torch.sum((out.color - t(target)) ** 2) + 0.1 * torch.sum(out.final_t)
    loss.backward()
    names = ("means3d", "scales", "opacity", "colors", "ndc_offset", "bg")
    for name, gj, x in zip(names, g_j, targs):
        gj = np.asarray(gj)
        scale = np.abs(gj).max() + 1e-6
        np.testing.assert_allclose(x.grad.numpy() / scale, gj / scale, atol=2e-4, err_msg=name)


def test_cpu_backward_never_builds_the_kernel(rng, monkeypatch):
    def refuse(self):
        raise AssertionError("a CPU gradient tried to build the CUDA backward kernel")

    monkeypatch.setattr(blend_cuda.BackwardKernel, "build", refuse)
    monkeypatch.setattr(blend_cuda.BackwardKernel, "library", refuse)
    launches = blend_cuda.BACKWARD.launches
    camera, means, scales, quats, opac, colors = make_scene(rng, n=30)
    m = t(means).requires_grad_(True)
    out = rasterize(m, t(opac), torch_camera(camera), colors=t(colors), scales=t(scales),
                    rotations=t(quats), config=RasterConfig(capacity=1 << 12))
    out.color.sum().backward()
    assert torch.isfinite(m.grad).all() and m.grad.abs().max() > 0
    assert not blend_cuda.BACKWARD.loaded and blend_cuda.BACKWARD.launches == launches


def test_autograd_function_routes_both_kernels(rng, monkeypatch):
    """``_BlendForward`` with its two kernels swapped for their plain
    versions on CPU tensors: the wrapper's plumbing (residuals, ``None``
    cotangents, ``d_bg``) gives the plain path's gradients."""
    a, grid = _binned_inputs(rng, 3)
    calls = {"fwd": 0, "bwd": 0}

    def fake_forward(gauss_s, tile_starts, table, bg, grid_x, tile_size):
        calls["fwd"] += 1
        with torch.no_grad():
            out = blend_cuda.blend_torch.blend(
                gauss_s.clamp_max(table.shape[0] - 1)[: int(tile_starts[-1])],
                torch.repeat_interleave(torch.arange(tile_starts.shape[0] - 1),
                                        (tile_starts[1:] - tile_starts[:-1]).long()),
                tile_starts, table[:, 0:2], table[:, 2:5], table[:, 5], table[:, 6:], bg,
                *grid)
        return out.tiles, out.final_t, out.n_contrib

    def fake_backward(gauss_s, tile_starts, table, bg, g_tiles, g_final_t, tiles, final_t,
                      grid_x, tile_size):
        calls["bwd"] += 1
        assert g_tiles.shape == tiles.shape and g_final_t.shape == final_t.shape
        return blend_cuda.blend_backward_plain(gauss_s, tile_starts, table, bg, g_tiles,
                                               g_final_t, grid)[0]

    monkeypatch.setattr(blend_cuda, "FORWARD", fake_forward)
    monkeypatch.setattr(blend_cuda, "BACKWARD", fake_backward)
    table = t(np.concatenate([a["means2d"], a["conics"], a["opacities"][:, None],
                              a["colors"]], axis=1))
    args = (t(a["gauss_id"]).long(), t(a["tile_starts"]))
    g_tiles, g_final_t = (t(x) for x in cotangents(9, grid[0] * grid[1], grid[2] ** 2, 3))
    for use_final_t in (False, True):
        tb = table.clone().requires_grad_(True)
        bg = t(a["bg"]).requires_grad_(True)
        tiles, final_t, _ = blend_cuda._BlendForward.apply(tb, bg, *args, grid[0], grid[2])
        loss = torch.sum(tiles * g_tiles)
        if use_final_t:
            loss = loss + torch.sum(final_t * g_final_t)
        loss.backward()
        want = blend_cuda.blend_backward_plain(*args, table, t(a["bg"]), g_tiles,
                                               g_final_t if use_final_t else None, grid)
        torch.testing.assert_close(tb.grad, want[0], atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(bg.grad, want[1], atol=1e-4, rtol=1e-5)
    assert calls == {"fwd": 2, "bwd": 2}
