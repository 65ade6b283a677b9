"""The Hopper blend kernels on the card, held against their plain versions.

Every test here needs an NVIDIA GPU and ``nvcc`` (the kernels have no CPU or
interpret mode) and skips without one.  The file imports nothing of JAX, so
on a machine with a card it runs without the JAX package:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances are those the Pallas kernels are held to: color 1e-4, final_t
5e-5, n_contrib exact; gradients within 2e-4 of each column's largest
absolute value (float32 sums in another order, atomics whose order changes
from run to run, and the U_total − prefix cancellation).
"""

import numpy as np
import pytest
import torch

from seganygaussians_torch.ops import blend as tblend
from seganygaussians_torch.ops import blend_cuda
from seganygaussians_torch.ops.binning import expand_slots, sort_instances
from seganygaussians_torch.ops.camera import make_camera
from seganygaussians_torch.ops.projection import preprocess
from seganygaussians_torch.ops.rasterize import RasterConfig, rasterize


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU or interpret mode)")
    return torch.device("cuda")


def scene(seed, n=400, c=3, width=96, height=64):
    rng = np.random.default_rng(seed)
    camera = make_camera(np.eye(3), np.zeros(3), fovx=1.2, fovy=0.9, width=width, height=height)
    z = rng.uniform(1.0, 6.0, n)
    means = np.stack([rng.uniform(-0.9, 0.9, n) * z * np.tan(0.6),
                      rng.uniform(-0.9, 0.9, n) * z * np.tan(0.45), z], 1)
    quats = rng.normal(size=(n, 4))
    arrays = dict(
        means=means, scales=rng.uniform(0.03, 0.25, (n, 3)),
        quats=quats / np.linalg.norm(quats, axis=1, keepdims=True),
        opac=rng.uniform(0.2, 0.95, n), colors=rng.uniform(size=(n, c)),
        bg=np.linspace(0.1, 0.9, c),
    )
    return camera, {k: torch.tensor(v, dtype=torch.float32) for k, v in arrays.items()}


def _binned(s, camera, c, grid=(6, 4, 16)):
    prep = preprocess(s["means"], camera, scales=s["scales"], rotations=s["quats"],
                      opacities=s["opac"])
    plan = expand_slots(prep, grid[0], grid[1], 1 << 14)
    n = s["means"].shape[0]
    gauss_s, tile_s, starts = sort_instances(plan.slot_rank, plan.slot_tile, n,
                                             grid[0] * grid[1])
    perm = plan.depth_perm
    table = torch.cat([prep.means2d[perm], prep.conics[perm], s["opac"][perm][:, None],
                       s["colors"][perm]], 1)
    return gauss_s, tile_s, starts, table


def _assert_cols_close(got, want, tol=2e-4):
    got, want = got.cpu().double().reshape(len(want), -1), want.double().reshape(len(want), -1)
    scale = want.abs().amax(dim=0) + 1e-6
    torch.testing.assert_close(got / scale, want / scale, atol=tol, rtol=0)


def _assert_close(got, want):
    got = [x.cpu() for x in got]
    torch.testing.assert_close(got[0], want.tiles, atol=1e-4, rtol=0)
    torch.testing.assert_close(got[1], want.final_t, atol=5e-5, rtol=0)
    assert torch.equal(got[2], want.n_contrib)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 4, 5, 32])
def test_kernel_matches_plain(cuda, c):
    camera, s = scene(c, c=c)
    prep = preprocess(s["means"], camera, scales=s["scales"], rotations=s["quats"],
                      opacities=s["opac"])
    grid = (6, 4, 16)
    plan = expand_slots(prep, grid[0], grid[1], 1 << 14)
    n = s["means"].shape[0]
    gauss_s, tile_s, starts = sort_instances(plan.slot_rank, plan.slot_tile, n, 24)
    perm = plan.depth_perm
    fields = (prep.means2d[perm], prep.conics[perm], s["opac"][perm], s["colors"][perm])
    want = tblend.blend(gauss_s.clamp_max(n - 1), tile_s, starts, *fields, s["bg"], *grid)
    table = torch.cat([fields[0], fields[1], fields[2][:, None], fields[3]], 1)
    before = blend_cuda.FORWARD.launches
    got = blend_cuda.FORWARD(gauss_s.to(cuda), starts.to(cuda), table.to(cuda),
                             s["bg"].to(cuda), grid[0], grid[2])
    torch.cuda.synchronize()
    assert blend_cuda.FORWARD.launches == before + 1
    assert int(want.n_contrib.max()) > 5
    _assert_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("with_depth", [False, True])
def test_rasterize_on_card_matches_cpu(cuda, with_depth):
    camera, s = scene(7)
    outs = {}
    for dev in ("cpu", cuda):
        d = {k: v.to(dev) for k, v in s.items()}
        outs[str(dev)] = rasterize(
            d["means"], d["opac"], camera, colors=d["colors"], scales=d["scales"],
            rotations=d["quats"], bg=d["bg"], with_depth=with_depth,
            config=RasterConfig(capacity=1 << 14),
        )
    a, b = outs["cpu"], outs[str(cuda)]
    torch.testing.assert_close(b.color.cpu(), a.color, atol=1e-4, rtol=0)
    torch.testing.assert_close(b.final_t.cpu(), a.final_t, atol=5e-5, rtol=0)
    assert torch.equal(b.n_contrib.cpu(), a.n_contrib)
    assert torch.equal(b.radii.cpu(), a.radii)
    if with_depth:
        torch.testing.assert_close(b.extra.cpu(), a.extra, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_run(cuda):
    camera, s = scene(3, n=60, c=6)
    d = {k: v.to(cuda) for k, v in s.items()}
    with pytest.raises(ValueError, match="C=6"):
        rasterize(d["means"], d["opac"], camera, colors=d["colors"], scales=d["scales"],
                  rotations=d["quats"], config=RasterConfig(capacity=1 << 12))
    gauss_s, _, starts, table = _binned(s, camera, 6)
    g = torch.zeros((24, 256, 6))
    with pytest.raises(ValueError, match="C=6"):
        blend_cuda.BACKWARD(*(x.to(cuda).contiguous() for x in (
            gauss_s, starts, table, s["bg"], g, g[..., 0], g, g[..., 0])), 6, 16)


@pytest.mark.cuda
def test_backward_gradient_reaches_every_input(cuda):
    """A loss of the color and final_t on the card gives finite, nonzero
    gradients for means, scales, opacity, colors, ndc_offset and bg."""
    camera, s = scene(3, n=60)
    d = {k: v.to(cuda).requires_grad_(True) for k, v in s.items() if k != "quats"}
    ndc = torch.zeros((60, 2), device=cuda, requires_grad=True)
    out = rasterize(d["means"], d["opac"], camera, colors=d["colors"], scales=d["scales"],
                    rotations=s["quats"].to(cuda), bg=d["bg"], ndc_offset=ndc,
                    config=RasterConfig(capacity=1 << 12))
    before = blend_cuda.BACKWARD.launches
    (out.color.square().sum() + out.final_t.sum()).backward()
    torch.cuda.synchronize()
    assert blend_cuda.BACKWARD.launches == before + 1
    for x in list(d.values()) + [ndc]:
        assert torch.isfinite(x.grad).all() and x.grad.abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 4, 5, 32])
def test_backward_kernel_matches_plain(cuda, c):
    camera, s = scene(c + 10, c=c)
    gauss_s, _, starts, table = _binned(s, camera, c)
    rng = np.random.default_rng(c)
    g_tiles = torch.tensor(rng.normal(size=(24, 256, c)), dtype=torch.float32)
    g_final_t = torch.tensor(rng.normal(size=(24, 256)), dtype=torch.float32)
    want = blend_cuda.blend_backward_plain(gauss_s, starts, table, s["bg"], g_tiles,
                                           g_final_t, (6, 4, 16))
    dev = [x.to(cuda) for x in (gauss_s, starts, table, s["bg"])]
    tiles, final_t, _ = blend_cuda.FORWARD(*dev, 6, 16)
    before = blend_cuda.BACKWARD.launches_by_channels[c]
    got = blend_cuda.blend_backward(*dev, tiles, final_t, g_tiles.to(cuda),
                                    g_final_t.to(cuda), 6, 16)
    torch.cuda.synchronize()
    assert blend_cuda.BACKWARD.launches_by_channels[c] == before + 1
    assert want[0][:, :6].abs().amax(dim=0).min() > 0
    _assert_cols_close(got[0], want[0])
    _assert_cols_close(got[1][None], want[1][None])


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 32])
def test_rasterize_gradients_on_card_match_cpu(cuda, c):
    camera, s = scene(c + 20, c=c)
    target = torch.tensor(np.random.default_rng(1).uniform(size=(64, 96, c)),
                          dtype=torch.float32)
    grads = {}
    for dev in ("cpu", cuda):
        d = {k: v.detach().clone().to(dev).requires_grad_(True) for k, v in s.items()}
        ndc = torch.zeros((400, 2), device=dev, requires_grad=True)
        out = rasterize(d["means"], d["opac"], camera, colors=d["colors"], scales=d["scales"],
                        rotations=d["quats"], bg=d["bg"], ndc_offset=ndc,
                        config=RasterConfig(capacity=1 << 14))
        loss = ((out.color - target.to(dev)) ** 2).sum() + 0.1 * out.final_t.sum()
        loss.backward()
        grads[str(dev)] = [x.grad for x in d.values()] + [ndc.grad]
    for a, b in zip(grads["cpu"], grads[str(cuda)]):
        scale = a.abs().max() + 1e-6
        torch.testing.assert_close(b.cpu() / scale, a / scale, atol=2e-4, rtol=0)
