"""Port parity: the row-footprint and sort-free raster plans.

The same seeded numpy scene goes through the JAX package's
``projection._row_intervals``, ``binning.plan_instances`` and
``binning.bin_gaussians`` and the port's, on the CPU: integer outputs exact.
Then the port alone: the row-footprint image against the rect image and the
sort-free image against the sorted one (1e-4, the JAX package's own
tolerance in ``tests/test_rasterize.py``; ``n_contrib`` exact), gradients
through both plans, and the sort-free overflow flag.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from seganygaussians_tpu.ops import binning as jbin
from seganygaussians_tpu.ops import projection as jproj
from seganygaussians_tpu.ops.rasterize import RasterConfig as JRasterConfig
from seganygaussians_tpu.ops.rasterize import rasterize as jrasterize
from seganygaussians_torch.ops import binning as tbin
from seganygaussians_torch.ops import projection as tproj
from seganygaussians_torch.ops.rasterize import RasterConfig, rasterize
from tests.test_rasterize import make_scene
from tests.test_torch_geometry import t, torch_camera

W, H, TS = 160, 112, 16
GX, GY = (W + TS - 1) // TS, (H + TS - 1) // TS


def anisotropic_scene(seed, n=400, c=3):
    """Strongly anisotropic, rotated footprints (where rows cut the most),
    as ``tests/test_rasterize.py:test_row_footprint_binning_matches_rect``."""
    rng = np.random.default_rng(seed)
    camera, means, _, quats, opac, colors = make_scene(rng, n=n, width=W, height=H, c=c)
    scales = np.stack([rng.uniform(0.01, 0.25, n), rng.uniform(0.005, 0.05, n),
                       rng.uniform(0.01, 0.25, n)], 1).astype(np.float32)
    opac = rng.uniform(0.05, 0.95, n).astype(np.float32)
    return camera, means, scales, quats, opac, colors


def preps(seed, row_footprints):
    camera, means, scales, quats, opac, colors = anisotropic_scene(seed)
    kw = dict(tile_size=TS, row_footprints=row_footprints)
    jp = jproj.preprocess(jnp.asarray(means), camera, scales=jnp.asarray(scales),
                          rotations=jnp.asarray(quats), opacities=jnp.asarray(opac), **kw)
    tp = tproj.preprocess(t(means), torch_camera(camera), scales=t(scales), rotations=t(quats),
                          opacities=t(opac), **kw)
    return jp, tp


@pytest.mark.parametrize("seed", [0, 1])
def test_row_intervals_match_jax(seed):
    jp, tp = preps(seed, row_footprints=False)
    rng = np.random.default_rng(seed + 10)
    tau = rng.uniform(-0.5, 5.0, jp.valid.shape[0]).astype(np.float32)
    args = (jp.means2d[:, 0], jp.means2d[:, 1], jp.conics, jnp.asarray(tau),
            jp.rect_min[:, 0], jp.rect_max[:, 0], jp.rect_min[:, 1], jp.rect_max[:, 1])
    want = jproj._row_intervals(*args, GY, TS)
    got = tproj._row_intervals(*(t(np.asarray(a)) for a in args), GY, TS)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[1].sum()) > 0


@pytest.mark.parametrize("row_footprints", [False, True])
def test_bin_gaussians_matches_jax(row_footprints):
    jp, tp = preps(2, row_footprints)
    want = jbin.bin_gaussians(jp, GX, GY, 1 << 14)
    got = tbin.bin_gaussians(tp, GX, GY, 1 << 14)
    total = int(want.num_instances)
    assert got.num_instances == total > 0 and not got.overflow and not bool(want.overflow)
    np.testing.assert_array_equal(got.tile_starts.numpy(), np.asarray(want.tile_starts))
    np.testing.assert_array_equal(got.tile_id.numpy(), np.asarray(want.tile_id))
    np.testing.assert_array_equal(got.depth_perm.numpy(), np.asarray(want.depth_perm))
    # Past the instances the packages pad with different ranks (n and 0).
    np.testing.assert_array_equal(got.gauss_id[:total].numpy(),
                                  np.asarray(want.gauss_id)[:total])


@pytest.mark.parametrize("row_footprints", [False, True])
def test_plan_instances_matches_jax(row_footprints):
    """``plan_instances`` strips the row data: both preps give the rect plan,
    and the plan equals the sorted instances of ``bin_gaussians``."""
    jp, tp = preps(3, row_footprints)
    cap = 1 << 14
    want = jbin.plan_instances(jp, GX, GY, cap)
    got = tbin.plan_instances(tp, GX, GY, cap)
    for name in ("sorted_gauss", "tile_starts", "dest", "offsets", "depth_perm"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert got.num_instances == int(want.num_instances) and not got.overflow
    binned = tbin.bin_gaussians(tbin.strip_row_footprints(tp), GX, GY, cap)
    total = int(binned.tile_starts[-1])
    assert torch.equal(binned.tile_starts, got.tile_starts)
    assert torch.equal(binned.gauss_id[:total], got.sorted_gauss[:total])


def test_plan_instances_overflow_flag():
    """Overflow truncates and says so; tile_starts stay within the capacity
    (as ``tests/test_rasterize.py:test_plan_instances_overflow_flag``), and
    the truncated plan is the JAX package's."""
    jp, tp = preps(3, row_footprints=False)
    total = int(tp.tiles_touched.sum())
    cap = (total // 2) // 256 * 256  # far below the instance count
    got, want = tbin.plan_instances(tp, GX, GY, cap), jbin.plan_instances(jp, GX, GY, cap)
    assert got.overflow and bool(want.overflow) and total > cap
    assert int(got.tile_starts.max()) <= cap
    np.testing.assert_array_equal(got.tile_starts.numpy(), np.asarray(want.tile_starts))
    np.testing.assert_array_equal(got.sorted_gauss.numpy(), np.asarray(want.sorted_gauss))
    with pytest.raises(ValueError, match="10 bits"):
        tbin.plan_instances(tp, 1024, 1, cap)


def _render(plan, seed=5, c=3, grad=False):
    camera, means, scales, quats, opac, colors = anisotropic_scene(seed, c=c)
    op, col = t(opac).requires_grad_(grad), t(colors).requires_grad_(grad)
    cfg = RasterConfig(capacity=1 << 15, row_footprints=plan == "rows",
                       backend="cuda_sortfree" if plan == "sortfree" else "auto")
    out = rasterize(t(means), op, torch_camera(camera), colors=col, scales=t(scales),
                    rotations=t(quats), bg=torch.linspace(0.1, 0.9, c), config=cfg)
    if not grad:
        return out, None
    (out.color.square().sum() + out.final_t.sum()).backward()
    return out, (op.grad, col.grad)


@pytest.mark.parametrize("plan", ["rows", "sortfree"])
@pytest.mark.parametrize("c", [3, 32])
def test_plan_renders_the_rect_image(plan, c):
    """Rows leave out only tiles the ellipse never reaches, and the sort-free
    plan is the sorted order: the same image, transmittance and
    contributions as the default plan, and the same gradients."""
    got, g_got = _render(plan, c=c, grad=True)
    want, g_want = _render("rect", c=c, grad=True)
    assert not got.overflow and not want.overflow
    torch.testing.assert_close(got.color, want.color, atol=1e-4, rtol=0)
    torch.testing.assert_close(got.final_t, want.final_t, atol=1e-4, rtol=0)
    assert torch.equal(got.n_contrib, want.n_contrib)
    for a, b in zip(g_got, g_want):
        scale = float(b.abs().max()) + 1e-6
        torch.testing.assert_close(a / scale, b / scale, atol=2e-4, rtol=0)


def test_row_plan_matches_jax_rasterize():
    """The port's row-footprint frame against the JAX package's (XLA
    backend) on the same scene."""
    camera, means, scales, quats, opac, colors = anisotropic_scene(6)
    want = jrasterize(jnp.asarray(means), jnp.asarray(opac), camera,
                      colors=jnp.asarray(colors), scales=jnp.asarray(scales),
                      rotations=jnp.asarray(quats),
                      config=JRasterConfig(capacity=1 << 15, backend="xla", row_footprints=True))
    got = rasterize(t(means), t(opac), torch_camera(camera), colors=t(colors),
                    scales=t(scales), rotations=t(quats),
                    config=RasterConfig(capacity=1 << 15, row_footprints=True))
    np.testing.assert_allclose(got.color.numpy(), np.asarray(want.color), atol=1e-4)
    np.testing.assert_array_equal(got.n_contrib.numpy(), np.asarray(want.n_contrib))
