"""Port parity: the plain blend (ops/blend.py) and the CUDA kernel's wrapper.

On the CPU the port's plain blend is held against the JAX package's XLA blend
and its Pallas kernel in interpret mode, with the tolerances the Pallas
kernel is held to (tests/test_blend_pallas.py): color 1e-4, final_t 5e-5,
n_contrib exact; and against the committed golden fixtures with
tests/test_golden.py's tolerances.  tests/test_torch_cuda.py holds the
Hopper kernel against the plain version on the card.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from seganygaussians_tpu.ops import blend as jblend
from seganygaussians_tpu.ops import blend_pallas
from seganygaussians_tpu.ops.binning import bin_gaussians
from seganygaussians_tpu.ops.projection import preprocess as jpreprocess
from seganygaussians_tpu.ops.rasterize import RasterConfig as JRasterConfig
from seganygaussians_tpu.ops.rasterize import rasterize as jrasterize
from seganygaussians_torch.ops import blend as tblend
from seganygaussians_torch.ops import blend_cuda
from seganygaussians_torch.ops.rasterize import RasterConfig, rasterize
from tests.test_golden import _load as load_golden
from tests.test_rasterize import make_scene
from tests.test_torch_geometry import t, torch_camera
from tools.make_golden import make_fixture_scene


def _binned_inputs(rng, c, n=120, width=64, height=48):
    """Sorted instances + depth-ranked fields from the JAX binning."""
    camera, means, scales, quats, opac, colors = make_scene(
        rng, n=n, c=c, width=width, height=height
    )
    ts = 16
    grid_x, grid_y = (width + ts - 1) // ts, (height + ts - 1) // ts
    prep = jpreprocess(
        jnp.asarray(means), camera, scales=jnp.asarray(scales),
        rotations=jnp.asarray(quats), opacities=jnp.asarray(opac),
    )
    binned = bin_gaussians(prep, grid_x, grid_y, 1 << 13)
    perm = np.asarray(binned.depth_perm)
    arrays = dict(
        gauss_id=np.asarray(binned.gauss_id),
        tile_id=np.asarray(binned.tile_id),
        tile_starts=np.asarray(binned.tile_starts),
        means2d=np.asarray(prep.means2d)[perm],
        conics=np.asarray(prep.conics)[perm],
        opacities=opac[perm],
        colors=colors[perm],
        bg=np.linspace(0.1, 0.9, c).astype(np.float32),
    )
    return arrays, (grid_x, grid_y, ts)


def _torch_blend(a, grid):
    return tblend.blend(
        t(a["gauss_id"]).long(), t(a["tile_id"]).long(), t(a["tile_starts"]),
        t(a["means2d"]), t(a["conics"]), t(a["opacities"]), t(a["colors"]),
        t(a["bg"]), *grid,
    )


def _assert_blend_close(got, want):
    np.testing.assert_allclose(np.asarray(got.tiles), np.asarray(want.tiles), atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.final_t), np.asarray(want.final_t), atol=5e-5)
    np.testing.assert_array_equal(np.asarray(got.n_contrib), np.asarray(want.n_contrib))


@pytest.mark.parametrize("jax_impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("c", [3, 4, 32])
def test_blend_matches_jax(rng, c, jax_impl):
    a, grid = _binned_inputs(rng, c)
    fn = jblend.blend if jax_impl == "xla" else blend_pallas.blend
    want = fn(
        *(jnp.asarray(a[k]) for k in ("gauss_id", "tile_id", "tile_starts", "means2d",
                                      "conics", "opacities", "colors", "bg")),
        *grid,
    )
    got = _torch_blend(a, grid)
    assert int(np.asarray(want.n_contrib).max()) > 3
    _assert_blend_close(got, want)


@pytest.mark.parametrize("jax_impl", ["xla", "pallas_interpret"])
def test_blend_more_than_32_channels_matches_jax(rng, jax_impl):
    """C = 40, which the Pallas kernel pads to a multiple of 8 and the card
    runs in two groups (32 + 8): the port's plain blend within 1e-5 of the
    JAX package's XLA blend, and within the tolerances the Pallas kernel is
    held to (its scan's float32 products differ from a float64 sum by up to
    1.2e-5 in final_t here) of the Pallas kernel."""
    a, grid = _binned_inputs(rng, 40)
    fn = jblend.blend if jax_impl == "xla" else blend_pallas.blend
    want = fn(
        *(jnp.asarray(a[k]) for k in ("gauss_id", "tile_id", "tile_starts", "means2d",
                                      "conics", "opacities", "colors", "bg")),
        *grid,
    )
    got = _torch_blend(a, grid)
    assert got.tiles.shape[-1] == 40 and int(np.asarray(want.n_contrib).max()) > 3
    if jax_impl == "pallas_interpret":
        _assert_blend_close(got, want)
        return
    np.testing.assert_allclose(got.tiles.numpy(), np.asarray(want.tiles), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.final_t.numpy(), np.asarray(want.final_t), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(got.n_contrib.numpy(), np.asarray(want.n_contrib))


@pytest.mark.parametrize("nan_column", [0, 2, 3])
def test_plain_blend_skips_a_nan_power_as_jax_does(nan_column):
    """A NaN mean or conic gives a NaN power.  Both plain versions keep an
    instance on ``power <= 0``, which is false for NaN: the instance is left
    out.  The Hopper kernels keep on the same test
    (tests/test_torch_cuda.py::test_nan_power_is_skipped_as_jax_does)."""
    row = [3.0, 5.0, 0.02, 0.0, 0.02, 0.5, 0.2, 0.4, 0.6]
    row[nan_column] = float("nan")
    table = np.array([row, [4.0, 4.0, 0.01, 0.0, 0.01, 0.6, 0.9, 0.1, 0.3]], np.float32)
    a = dict(gauss_id=np.array([0, 1], np.int32), tile_id=np.array([0, 0], np.int32),
             tile_starts=np.array([0, 2], np.int32), means2d=table[:, 0:2], conics=table[:, 2:5],
             opacities=table[:, 5], colors=table[:, 6:], bg=np.array([0.1, 0.5, 0.9], np.float32))
    grid = (1, 1, 16)
    want = jblend.blend(
        *(jnp.asarray(a[k]) for k in ("gauss_id", "tile_id", "tile_starts", "means2d",
                                      "conics", "opacities", "colors", "bg")),
        *grid,
    )
    got = _torch_blend(a, grid)
    assert np.isfinite(got.tiles.numpy()).all()
    np.testing.assert_array_equal(got.n_contrib.numpy(), np.ones((1, 256), np.int32))
    _assert_blend_close(got, want)


@pytest.mark.parametrize("c", [3, 32])
def test_golden_forward(c):
    g = load_golden(c)
    camera, means, scales, quats, opac, colors, bg = make_fixture_scene(c)
    out = rasterize(
        t(means), t(opac), torch_camera(camera), colors=t(colors), scales=t(scales),
        rotations=t(quats), bg=t(bg), with_depth=(c == 3),
        config=RasterConfig(capacity=1 << 13),
    )
    np.testing.assert_allclose(out.color.numpy(), g["color"], atol=2e-4)
    np.testing.assert_allclose(out.final_t.numpy(), g["final_t"], atol=1e-4)
    np.testing.assert_array_equal(out.n_contrib.numpy(), g["n_contrib"])
    if c == 3:
        np.testing.assert_allclose(out.extra.numpy(), g["extra"], atol=2e-3)


def test_cpu_call_never_builds_the_kernel(rng, monkeypatch):
    def refuse(self):
        raise AssertionError("a CPU call tried to build the CUDA kernel")

    monkeypatch.setattr(blend_cuda.ForwardKernel, "build", refuse)
    monkeypatch.setattr(blend_cuda.ForwardKernel, "library", refuse)
    launches = blend_cuda.FORWARD.launches
    camera, means, scales, quats, opac, colors = make_scene(rng, n=40)
    kw = dict(colors=t(colors), scales=t(scales), rotations=t(quats))
    auto = rasterize(t(means), t(opac), torch_camera(camera), **kw,
                     config=RasterConfig(capacity=1 << 12, backend="auto"))
    plain = rasterize(t(means), t(opac), torch_camera(camera), **kw,
                      config=RasterConfig(capacity=1 << 12, backend="torch"))
    assert not blend_cuda.FORWARD.loaded
    assert blend_cuda.FORWARD.launches == launches
    # blend_fused's CPU path is the plain version itself.
    assert torch.equal(auto.color, plain.color)
    assert torch.equal(auto.n_contrib, plain.n_contrib)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rasterize(t(means), t(opac), torch_camera(camera), **kw,
                  config=RasterConfig(capacity=1 << 12, backend="cuda"))


def test_cpu_gradients_match_jax(rng):
    """The CPU path is ordinary autograd; its gradients match jax.grad of the
    XLA path (the next slice's reference for the backward kernel)."""
    camera, means, scales, quats, opac, colors = make_scene(rng, n=40)
    bg = np.array([0.3, 0.5, 0.7], np.float32)
    target = np.random.default_rng(3).uniform(size=(32, 48, 3)).astype(np.float32)

    def jloss(m, o, col, off):
        out = jrasterize(m, o, camera, colors=col, scales=jnp.asarray(scales),
                         rotations=jnp.asarray(quats), bg=jnp.asarray(bg), ndc_offset=off,
                         config=JRasterConfig(capacity=1 << 13, backend="xla"))
        return jnp.sum((out.color - target) ** 2) + 0.1 * jnp.sum(out.final_t)

    jargs = (jnp.asarray(means), jnp.asarray(opac), jnp.asarray(colors), jnp.zeros((40, 2)))
    g_j = jax.grad(jloss, argnums=(0, 1, 2, 3))(*jargs)

    targs = [t(means), t(opac), t(colors), torch.zeros((40, 2))]
    for x in targs:
        x.requires_grad_(True)
    out = rasterize(targs[0], targs[1], torch_camera(camera), colors=targs[2],
                    scales=t(scales), rotations=t(quats), bg=t(bg), ndc_offset=targs[3],
                    config=RasterConfig(capacity=1 << 13))
    loss = torch.sum((out.color - t(target)) ** 2) + 0.1 * torch.sum(out.final_t)
    loss.backward()
    for name, gj, x in zip(("means3d", "opacity", "colors", "ndc_offset"), g_j, targs):
        gj = np.asarray(gj)
        scale = np.abs(gj).max() + 1e-6
        np.testing.assert_allclose(x.grad.numpy() / scale, gj / scale, atol=2e-4, err_msg=name)
