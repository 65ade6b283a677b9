"""The Hopper kernels on the card, held against their plain versions.

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

import chip_smoke
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
                      tile_size=grid[2], opacities=s["opac"])
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


def _assert_bg_close(got, want, terms, tol=2e-4):
    """d_bg = Σ g·T within ``tol`` of the size of its terms, ``terms`` =
    ``chip_smoke.bg_terms``: the sum can cancel to a small fraction of them,
    where two float32 summation orders differ by more than a fraction of the
    sum itself."""
    scale = terms.cpu().double() + 1e-6
    torch.testing.assert_close(got.cpu().double() / scale, want.double() / scale, atol=tol,
                               rtol=0)


def _assert_close(got, want):
    got = [x.cpu() for x in got]
    torch.testing.assert_close(got[0], want.tiles, atol=1e-4, rtol=0)
    torch.testing.assert_close(got[1], want.final_t, atol=5e-5, rtol=0)
    assert torch.equal(got[2], want.n_contrib)


# 96×64 pixels as 16×16 tiles (8 warps a block), as 8×8 tiles (2 warps) and
# as 32×32 tiles (four blocks of 8 warps a tile).  C = 6, 16 and 24 run
# through the instances for 8, 16 and 24 (6 on zero-padded columns).
GRIDS = {16: (6, 4, 16), 8: (12, 8, 8), 32: (3, 2, 32)}
C_AND_TILE = [(3, 16), (4, 16), (5, 16), (32, 16), (3, 8), (32, 8),
              (6, 16), (16, 16), (24, 16), (3, 32), (32, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("c, tile_size", C_AND_TILE)
def test_kernel_matches_plain(cuda, c, tile_size):
    camera, s = scene(c, c=c)
    grid = GRIDS[tile_size]
    prep = preprocess(s["means"], camera, scales=s["scales"], rotations=s["quats"],
                      tile_size=tile_size, opacities=s["opac"])
    plan = expand_slots(prep, grid[0], grid[1], 1 << 14)
    n = s["means"].shape[0]
    gauss_s, tile_s, starts = sort_instances(plan.slot_rank, plan.slot_tile, n,
                                             grid[0] * grid[1])
    perm = plan.depth_perm
    fields = (prep.means2d[perm], prep.conics[perm], s["opac"][perm], s["colors"][perm])
    want = tblend.blend(gauss_s.clamp_max(n - 1), tile_s, starts, *fields, s["bg"], *grid)
    table = torch.cat([fields[0], fields[1], fields[2][:, None], fields[3]], 1)
    before = blend_cuda.FORWARD.launches
    instance = blend_cuda.FORWARD.launches_by_channels[blend_cuda.instance_channels(c)]
    name = blend_cuda.instance_name(c, tile_size)
    by_name = blend_cuda.FORWARD.launches_by_instance.get(name, 0)
    got = blend_cuda.FORWARD(gauss_s.to(cuda), starts.to(cuda), table.to(cuda),
                             s["bg"].to(cuda), grid[0], grid[2])
    torch.cuda.synchronize()
    assert blend_cuda.FORWARD.launches == before + 1
    assert blend_cuda.FORWARD.launches_by_channels[
        blend_cuda.instance_channels(c)] == instance + 1
    assert blend_cuda.FORWARD.launches_by_instance[name] == by_name + 1
    assert got[0].shape == want.tiles.shape
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
    """Tiles other than 8, 16 and 32 raise on the card; nothing falls back
    to the plain version.  C = 33, which raised before the kernels ran more
    than 32 channels in groups, now goes through them (32 + 1 channels)."""
    camera, s = scene(3, n=60, c=33)
    d = {k: v.to(cuda) for k, v in s.items()}
    before = dict(blend_cuda.FORWARD.launches_by_instance)
    out = rasterize(d["means"], d["opac"], camera, colors=d["colors"], scales=d["scales"],
                    rotations=d["quats"], config=RasterConfig(capacity=1 << 12))
    torch.cuda.synchronize()
    after = blend_cuda.FORWARD.launches_by_instance
    assert [after.get(k, 0) - before.get(k, 0) for k in ("C=32", "C=8")] == [1, 1]
    want = rasterize(s["means"], s["opac"], camera, colors=s["colors"], scales=s["scales"],
                     rotations=s["quats"], config=RasterConfig(capacity=1 << 12))
    torch.testing.assert_close(out.color.cpu(), want.color, atol=1e-4, rtol=0)
    gauss_s, _, starts, table = _binned(s, camera, 33)
    g = torch.zeros((24, 256, 33))
    d_table = blend_cuda.BACKWARD(*(x.to(cuda).contiguous() for x in (
        gauss_s, starts, table, s["bg"], g, g[..., 0], g, g[..., 0])), 6, 16)
    assert d_table.shape == table.shape and not d_table.any()
    camera, s = scene(3, n=60, c=3)
    d = {k: v.to(cuda) for k, v in s.items()}
    with pytest.raises(ValueError, match="tile_size 12 unsupported"):
        rasterize(d["means"], d["opac"], camera, colors=d["colors"], scales=d["scales"],
                  rotations=d["quats"], config=RasterConfig(capacity=1 << 12, tile_size=12))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [40, 64])
def test_more_than_32_channels_run_in_groups(cuda, c):
    """C = 40 and 64 on a whole small frame: the forward and backward in
    groups of at most 32 (one launch a group) against the plain versions at
    the card tolerances; final_t and n_contrib are the same in every group."""
    camera, s = scene(c, c=c)
    grid = GRIDS[16]
    num_tiles, p = grid[0] * grid[1], 256
    gauss_s, tile_s, starts, table = _binned(s, camera, c, grid)
    n = table.shape[0]
    want = tblend.blend(gauss_s.clamp_max(n - 1), tile_s, starts, table[:, 0:2], table[:, 2:5],
                        table[:, 5], table[:, 6:], s["bg"], *grid)
    dev = [x.to(cuda) for x in (gauss_s, starts, table, s["bg"])]
    before = dict(blend_cuda.FORWARD.launches_by_instance)
    got = blend_cuda.FORWARD(*dev, grid[0], 16)
    torch.cuda.synchronize()
    after = blend_cuda.FORWARD.launches_by_instance
    groups = blend_cuda.channel_groups(c)
    assert sum(after.get(k, 0) - before.get(k, 0) for k in after) == len(groups)
    assert after["C=32"] - before.get("C=32", 0) == c // 32
    _assert_close(got, want)
    for lo, hi in groups[1:]:
        alone = blend_cuda.FORWARD(dev[0], dev[1], torch.cat([dev[2][:, :6],
                                   dev[2][:, 6 + lo:6 + hi]], 1).contiguous(),
                                   dev[3][lo:hi].contiguous(), grid[0], 16)
        assert torch.equal(alone[1], got[1]) and torch.equal(alone[2], got[2])
    rng = np.random.default_rng(c)
    g_tiles = torch.tensor(rng.normal(size=(num_tiles, p, c)), dtype=torch.float32)
    g_final_t = torch.tensor(rng.normal(size=(num_tiles, p)), dtype=torch.float32)
    want_g = blend_cuda.blend_backward_plain(gauss_s, starts, table, s["bg"], g_tiles,
                                             g_final_t, grid)
    before = blend_cuda.BACKWARD.launches
    got_g = blend_cuda.blend_backward(*dev, got[0], got[1], g_tiles.to(cuda),
                                      g_final_t.to(cuda), grid[0], 16)
    torch.cuda.synchronize()
    assert blend_cuda.BACKWARD.launches == before + len(groups)
    _assert_cols_close(got_g[0], want_g[0])
    _assert_bg_close(got_g[1], want_g[1], chip_smoke.bg_terms(g_tiles, got[1].cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("plan", ["rows", "sortfree"])
@pytest.mark.parametrize("c", [3, 32])
def test_raster_plans_on_card_match_cpu(cuda, plan, c):
    """The row-footprint and sort-free plans on the card (both kernels)
    against the CPU (the plain version): the frame at the forward's
    tolerances and the gradients within 2e-4 of each array's largest
    value."""
    camera, s = scene(c + 30, c=c)
    cfg = RasterConfig(capacity=1 << 14, row_footprints=plan == "rows",
                       backend="cuda_sortfree" if plan == "sortfree" else "auto")
    outs, grads = {}, {}
    for dev in ("cpu", cuda):
        d = {k: v.detach().clone().to(dev).requires_grad_(k in ("opac", "colors", "means"))
             for k, v in s.items()}
        before = blend_cuda.BACKWARD.launches
        out = rasterize(d["means"], d["opac"], camera, colors=d["colors"], scales=d["scales"],
                        rotations=d["quats"], bg=d["bg"], config=cfg)
        (out.color.square().sum() + out.final_t.sum()).backward()
        if dev != "cpu":
            torch.cuda.synchronize()
            assert blend_cuda.BACKWARD.launches == before + 1
        outs[str(dev)] = out
        grads[str(dev)] = [d[k].grad for k in ("means", "opac", "colors")]
    a, b = outs["cpu"], outs[str(cuda)]
    torch.testing.assert_close(b.color.detach().cpu(), a.color.detach(), atol=1e-4, rtol=0)
    torch.testing.assert_close(b.final_t.detach().cpu(), a.final_t.detach(), atol=5e-5, rtol=0)
    assert torch.equal(b.n_contrib.cpu(), a.n_contrib)
    for ga, gb in zip(grads["cpu"], grads[str(cuda)]):
        scale = float(ga.abs().max()) + 1e-6
        torch.testing.assert_close(gb.cpu() / scale, ga / scale, atol=2e-4, rtol=0)


@pytest.mark.cuda
def test_dp_step_on_nccl_at_world_size_one(cuda):
    """One ``make_dp_train_step`` on a real NCCL process group of one rank
    equals the same step run in turn (no process group), and it launched
    both kernels."""
    import socket

    import torch.distributed as dist

    from seganygaussians_torch.models import gaussians as gm
    from seganygaussians_torch.parallel import data_parallel
    from seganygaussians_torch.parallel.mesh import Layout, initialize_distributed, make_mesh

    rng = np.random.default_rng(0)
    n = 200
    pts = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
                    3 + rng.uniform(-0.3, 0.3, n)], 1).astype(np.float32)
    state = gm.create_from_points(pts, rng.uniform(size=(n, 3)).astype(np.float32), 0, 256,
                                  device=cuda)
    cam = make_camera(np.eye(3), np.zeros(3), fovx=0.9, fovy=0.7, width=64, height=48)
    batch, template = data_parallel.stack_cameras([cam])
    gts = torch.tensor(rng.uniform(size=(1, 48, 64, 3)), dtype=torch.float32, device=cuda)
    bg = torch.zeros(3, device=cuda)
    args = (gm.TrainHyper(), RasterConfig(capacity=1 << 14), 2.0, 0)
    want = data_parallel.make_dp_train_step(Layout(("data",), (1,)), template, *args)(
        state, batch, gts, bg, 1)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    initialize_distributed("cuda", init_method=f"tcp://localhost:{port}", world_size=1, rank=0,
                           timeout_s=60)
    try:
        assert dist.get_backend() == "nccl"
        fwd, bwd = blend_cuda.FORWARD.launches, blend_cuda.BACKWARD.launches
        got = data_parallel.make_dp_train_step(make_mesh(1), template, *args)(
            state, batch, gts, bg, 1)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    assert blend_cuda.FORWARD.launches == fwd + 1 and blend_cuda.BACKWARD.launches == bwd + 1
    assert abs(float(got[1]) - float(want[1])) <= 1e-6
    assert float((got[0].params.xyz - state.params.xyz).abs().max()) > 0
    # The gradient, to tell which coordinates' first Adam step the atomics'
    # rounding may turn round (``chip_smoke.adam_step_error``).
    from seganygaussians_torch.ops import losses

    xyz = state.params.xyz.detach().requires_grad_(True)
    p = state.params._replace(xyz=xyz)
    out = rasterize(xyz, gm.get_opacity(p)[:, 0], cam, shs=gm.get_shs(p), sh_degree=0,
                    scales=gm.get_scaling(p), rotations=gm.get_rotation(p), bg=bg,
                    active_mask=state.alive, config=args[1])
    hyper = args[0]
    loss = ((1 - hyper.lambda_dssim) * losses.l1_loss(out.color, gts[0])
            + hyper.lambda_dssim * (1 - losses.ssim(out.color, gts[0])))
    (g_xyz,) = torch.autograd.grad(loss, [xyz])
    err, _ = chip_smoke.adam_step_error(got[0].params.xyz, want[0].params.xyz, g_xyz)
    assert err <= 1e-6


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
@pytest.mark.parametrize("c, tile_size", C_AND_TILE)
def test_backward_kernel_matches_plain(cuda, c, tile_size):
    camera, s = scene(c + 10, c=c)
    grid = GRIDS[tile_size]
    num_tiles, p = grid[0] * grid[1], tile_size * tile_size
    gauss_s, _, starts, table = _binned(s, camera, c, grid)
    rng = np.random.default_rng(c)
    g_tiles = torch.tensor(rng.normal(size=(num_tiles, p, c)), dtype=torch.float32)
    g_final_t = torch.tensor(rng.normal(size=(num_tiles, p)), dtype=torch.float32)
    want = blend_cuda.blend_backward_plain(gauss_s, starts, table, s["bg"], g_tiles,
                                           g_final_t, grid)
    dev = [x.to(cuda) for x in (gauss_s, starts, table, s["bg"])]
    tiles, final_t, _ = blend_cuda.FORWARD(*dev, grid[0], tile_size)
    instance = blend_cuda.instance_channels(c)
    before = blend_cuda.BACKWARD.launches_by_channels[instance]
    name = blend_cuda.instance_name(c, tile_size)
    by_name = blend_cuda.BACKWARD.launches_by_instance.get(name, 0)
    got = blend_cuda.blend_backward(*dev, tiles, final_t, g_tiles.to(cuda),
                                    g_final_t.to(cuda), grid[0], tile_size)
    torch.cuda.synchronize()
    assert blend_cuda.BACKWARD.launches_by_channels[instance] == before + 1
    assert blend_cuda.BACKWARD.launches_by_instance[name] == by_name + 1
    assert got[0].shape == want[0].shape
    assert want[0][:, :6].abs().amax(dim=0).min() > 0
    _assert_cols_close(got[0], want[0])
    _assert_bg_close(got[1], want[1], chip_smoke.bg_terms(g_tiles, final_t.cpu()))


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


# --------------------------------------------------------------------------
# The kernels' inner edges: 4-instance groups, 8-instance sub-chunks, 64-row
# batches, empty tiles, saturation at any place of a range, padding ranks
# --------------------------------------------------------------------------


def _edge_frames(c, opaque, cuda, tile_size=16):
    """The same seeded strip of tiles on the CPU (for the plain version) and
    on the card: ranges of 0..200 instances around every inner edge."""
    cpu = chip_smoke.edge_case_frame(c, 40 + c, torch.device("cpu"), opaque=opaque,
                                     tile_size=tile_size)
    dev = {k: v.to(cuda) if isinstance(v, torch.Tensor) else v for k, v in cpu.items()}
    return cpu, dev


@pytest.mark.cuda
@pytest.mark.parametrize("opaque", [False, True])
@pytest.mark.parametrize("c, tile_size", C_AND_TILE)
def test_forward_kernel_at_range_edges(cuda, c, tile_size, opaque):
    cpu, dev = _edge_frames(c, opaque, cuda, tile_size)
    live = cpu["num_instances"]
    want = chip_smoke.run_plain(cpu, cpu["gauss_s"][:live], cpu["tile_s"], cpu["tile_starts"])
    got = chip_smoke.run_kernel(dev)
    torch.cuda.synchronize()
    assert int(want.n_contrib.max()) > 10
    if opaque:  # pixels saturate inside the ranges, not only at their ends
        assert float(want.final_t.min()) < 2e-4
    _assert_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("opaque", [False, True])
@pytest.mark.parametrize("c, tile_size", C_AND_TILE)
def test_backward_kernel_at_range_edges(cuda, c, tile_size, opaque):
    cpu, dev = _edge_frames(c, opaque, cuda, tile_size)
    g_tiles, g_final_t = chip_smoke.grad_inputs(cpu, 7 + c)
    want = chip_smoke.run_backward_plain(cpu, cpu["gauss_s"], cpu["tile_starts"], g_tiles,
                                         g_final_t)
    got = chip_smoke.run_backward(dev, dev["gauss_s"], dev["tile_starts"], g_tiles.to(cuda),
                                  g_final_t.to(cuda))
    torch.cuda.synchronize()
    _assert_cols_close(got[0], want[0])
    _assert_bg_close(got[1], want[1], got[2])


@pytest.mark.cuda
@pytest.mark.parametrize("opaque", [False, True])
@pytest.mark.parametrize("c, tile_size", [(3, 16), (32, 16), (3, 8), (32, 8), (16, 16),
                                         (3, 32), (32, 32)])
def test_forward_and_backward_include_the_same_pairs(cuda, c, tile_size, opaque):
    """Under an all-ones color cotangent a Gaussian's color gradient is the
    sum of its weights over the pixels that included it: nonzero exactly for
    the Gaussians the forward march (here the plain version's) included."""
    cpu, dev = _edge_frames(c, opaque, cuda, tile_size)
    ones = torch.ones((len(chip_smoke.EDGE_LENGTHS), tile_size * tile_size, c))
    want = chip_smoke.run_backward_plain(cpu, cpu["gauss_s"], cpu["tile_starts"], ones, None)
    got = chip_smoke.run_backward(dev, dev["gauss_s"], dev["tile_starts"], ones.to(cuda), None)
    torch.cuda.synchronize()
    included = want[0][:, 6:] != 0
    assert included.any() and not included.all()
    assert torch.equal(got[0][:, 6:].cpu() != 0, included)


@pytest.mark.cuda
@pytest.mark.parametrize("tile_size", [16, 8, 32])
@pytest.mark.parametrize("opacity", [0.5, 0.001])
@pytest.mark.parametrize("nan_column", [0, 2, 3])
def test_nan_power_is_skipped_as_jax_does(cuda, nan_column, opacity, tile_size):
    """A NaN mean or conic gives a NaN power.  The kernels keep an instance
    only on ``power <= 0``, as ``ops/blend.py`` and the JAX package do
    (tests/test_torch_blend.py::test_plain_blend_skips_a_nan_power_as_jax_does):
    such a row is left out at any opacity, in the forward and in the
    backward's re-march, whether or not the per-warp culling could have left
    it out.  The expectations come from the plain versions on the CPU."""
    p = tile_size * tile_size
    bg = torch.tensor([0.1, 0.5, 0.9])
    row = [3.0, 5.0, 0.02, 0.0, 0.02, opacity, 0.2, 0.4, 0.6]
    row[nan_column] = float("nan")
    # Behind it a sound splat that reaches every pixel of the tile.
    conic = 0.01 if tile_size < 32 else 0.002
    table = torch.tensor([row, [4.0, 4.0, conic, 0.0, conic, 0.6, 0.9, 0.1, 0.3]])
    gauss_s = torch.tensor([0, 1], dtype=torch.int64)
    starts = torch.tensor([0, 2], dtype=torch.int32)
    want = tblend.blend(gauss_s, torch.zeros(2, dtype=torch.int64), starts, table[:, 0:2],
                        table[:, 2:5], table[:, 5], table[:, 6:], bg, 1, 1, tile_size)
    assert torch.equal(want.n_contrib, torch.ones((1, p), dtype=torch.int32))
    args = [x.to(cuda) for x in (gauss_s, starts, table, bg)]
    got = blend_cuda.FORWARD(*args, 1, tile_size)
    torch.cuda.synchronize()
    _assert_close(got, want)
    g_tiles = torch.ones((1, p, 3))
    g_final_t = torch.full((1, p), 0.5)
    d_table, d_bg = blend_cuda.blend_backward(*args, got[0], got[1], g_tiles.to(cuda),
                                              g_final_t.to(cuda), 1, tile_size)
    torch.cuda.synchronize()
    want_d, want_bg = blend_cuda.blend_backward_plain(gauss_s, starts, table, bg, g_tiles,
                                                      g_final_t, (1, 1, tile_size))
    # The NaN row is never included: no entry of its row is touched.  (The
    # plain version's autograd gives NaN in its geometry columns: 0 · NaN.)
    assert torch.equal(d_table[0].cpu(), torch.zeros(9))
    assert torch.equal(want_d[0, 6:], torch.zeros(3))
    _assert_cols_close(d_table[1:], want_d[1:])
    _assert_bg_close(d_bg, want_bg, chip_smoke.bg_terms(g_tiles, got[1].cpu()))


# --------------------------------------------------------------------------
# The scan micro-benchmark kernel and the contrastive step
# --------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["exp_only", "log_tri", "log_tri_hs", "roll_lane",
                                     "roll_sub", "seq_march"])
def test_scan_kernel_matches_plain(cuda, variant):
    """csrc/scan_variants.cu against scan_variants_plain on the card, 1e-4
    relative (float32 products in another order; log_tri's plain version
    rounds to TF32 where the tensor cores do)."""
    from seganygaussians_torch.tools import bench_scan_variants as tool

    s = tool.seeded_block(cuda)
    for n_chunk in (3, 200):
        before = tool.SCAN.launches_of(variant)
        got = tool.scan_variants(s, variant, n_chunk)
        torch.cuda.synchronize()
        assert tool.SCAN.launches_of(variant) == before + 1
        want = tool.scan_variants_plain(s, variant, n_chunk, tf32=True)
        rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max()
        assert float(rel) <= 1e-4, (variant, n_chunk, float(rel))
    with pytest.raises(ValueError):
        tool.SCAN(s[:128].contiguous(), variant, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("smooth_type", ["traditional", "none"])
def test_contrastive_step_on_card_matches_cpu(cuda, smooth_type):
    """One contrastive_step with the same draws on the card (both blend
    kernels at C = 32) and on the CPU (autograd through ops/blend.py): loss
    and metrics to 1e-5, gradients to 2e-4 of each array's largest value."""
    from seganygaussians_torch.models import feature_gaussians as fgm
    from seganygaussians_torch.models import optim
    from seganygaussians_torch.ops.quantile import fit_quantile_transform
    from seganygaussians_torch.seg.scale_gate import ScaleGateParams
    from seganygaussians_torch.train import contrastive_trainer as ct

    rng = np.random.default_rng(5)
    n, w, h, rays = 300, 64, 48, 64
    pts = np.concatenate([rng.normal([-0.5, 0, 3.0], 0.2, (n // 2, 3)),
                          rng.normal([0.5, 0, 3.0], 0.2, (n // 2, 3))]).astype(np.float32)
    ys, xs = np.mgrid[:h, :w]
    masks = np.stack([np.ones((h, w), bool), xs < w // 2, xs >= w // 2,
                      (ys - 24) ** 2 + (xs - 20) ** 2 < 100])
    scales = np.array([5.0, 1.2, 1.0, 0.4], np.float32)
    geometry = (pts, np.log(rng.uniform(0.04, 0.1, (n, 3))).astype(np.float32),
                rng.normal(size=(n, 4)).astype(np.float32),
                rng.normal(1.0, 1.0, (n, 1)).astype(np.float32))
    gate_w = torch.tensor(rng.uniform(-1, 1, (1, 32)), dtype=torch.float32)
    gate_b = torch.tensor(rng.uniform(-1, 1, 32), dtype=torch.float32)
    camera = make_camera(np.eye(3), np.zeros(3), fovx=1.1, fovy=0.9, width=w, height=h)
    hyper = ct.ContrastiveHyper(num_sampled_rays=rays, smooth_k=8, smooth_type=smooth_type,
                                debug_grads=True)
    cpu_state = fgm.from_scene_geometry(*geometry, capacity=320, smooth_k=8, device="cpu")
    cpu_bundle = ct.build_mask_bundle(masks, scales, 5, device="cpu")
    draws = ct.draw_step(torch.Generator().manual_seed(3), cpu_bundle, hyper, 8)

    def to(tree, dev):
        if isinstance(tree, torch.Tensor):
            return tree.to(dev)
        if isinstance(tree, tuple):
            vals = [to(x, dev) for x in tree]
            return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
        return tree

    results = {}
    for dev in ("cpu", cuda):
        state = to(cpu_state, dev)
        gate = ScaleGateParams(gate_w.to(dev), gate_b.to(dev))
        consts = ct.ContrastiveConsts(
            upper_bound_scale=torch.tensor(5.0, device=dev),
            qt=fit_quantile_transform(torch.tensor(scales, device=dev)))
        fwd = blend_cuda.FORWARD.launches_by_channels[32]
        bwd = blend_cuda.BACKWARD.launches_by_channels[32]
        _, _, _, aux = ct.contrastive_step(
            state, gate, optim.adam_init(gate), camera, to(cpu_bundle, dev), consts, hyper,
            RasterConfig(capacity=1 << 13), draws=to(draws, dev))
        if dev != "cpu":
            torch.cuda.synchronize()
            assert blend_cuda.FORWARD.launches_by_channels[32] == fwd + 1
            assert blend_cuda.BACKWARD.launches_by_channels[32] == bwd + 1
        results[str(dev)] = aux
    a, b = results["cpu"], results[str(cuda)]
    for name in ("loss", "rfn", "cosine_pos", "cosine_neg"):
        assert abs(float(a[name]) - float(b[name])) <= 1e-5, name
    for ga, gb in ((a["feat_grads"], b["feat_grads"]), (a["gate_grads"].w, b["gate_grads"].w),
                   (a["gate_grads"].b, b["gate_grads"].b)):
        scale = ga.abs().max()
        assert float(scale) > 0
        assert float((gb.cpu() - ga).abs().max()) <= 2e-4 * float(scale)


# --------------------------------------------------------------------------
# The interactive session and the query layer on the card against the CPU
# --------------------------------------------------------------------------


def _session(device, feature_dim, seed=0, n=300, cap=384):
    """A seeded SagaSession on ``device``: features by the side of the scene
    a point is on, plus noise; a K = 8 neighbour map made on the CPU."""
    from seganygaussians_torch.models import feature_gaussians as fgm
    from seganygaussians_torch.models import gaussians as gm
    from seganygaussians_torch.ops.knn import knn_map
    from seganygaussians_torch.ops.quantile import fit_quantile_transform
    from seganygaussians_torch.seg.scale_gate import ScaleGateParams
    from seganygaussians_torch.viewer.interactive import SagaSession

    rng = np.random.default_rng(seed)
    xyz = rng.normal(scale=0.4, size=(n, 3))
    xyz[:, 2] += 3.0
    dirs = rng.normal(size=(3, feature_dim))
    group = (xyz[:, 0] > 0).astype(int) + (xyz[:, 1] > 0.1)
    a = {k: torch.tensor(v, dtype=torch.float32) for k, v in dict(
        xyz=xyz, features_dc=rng.normal(0, 0.8, (n, 1, 3)), features_rest=rng.normal(0, 0.2, (n, 3, 3)),
        scaling=np.log(rng.uniform(0.03, 0.1, (n, 3))), rotation=rng.normal(size=(n, 4)),
        opacity=rng.normal(1.0, 1.0, (n, 1)),
        features=dirs[group] + 0.5 * rng.normal(size=(n, feature_dim))).items()}
    smooth_map = torch.cat([torch.arange(n)[:, None], knn_map(a["xyz"], 7)], 1)
    gate = ScaleGateParams(torch.tensor(rng.normal(0, 0.5, (1, feature_dim)), dtype=torch.float32),
                           torch.tensor(rng.normal(1.5, 0.5, feature_dim), dtype=torch.float32))
    state = gm.from_dense(*(a[k].numpy() for k in ("xyz", "features_dc", "features_rest",
                                                     "scaling", "rotation", "opacity")),
                          capacity=cap, device=device)
    fs = fgm.FeatureState(
        geom=fgm.FrozenGeometry(xyz=a["xyz"].to(device), scaling=a["scaling"].to(device),
                                rotation=a["rotation"].to(device), opacity=a["opacity"].to(device),
                                alive=torch.ones(n, dtype=torch.bool, device=device)),
        point_features=a["features"].to(device), smooth_map=smooth_map.to(device), opt=None)
    s = SagaSession(state, fs, ScaleGateParams(gate.w.to(device), gate.b.to(device)),
                    fit_quantile_transform(torch.tensor(rng.uniform(0.5, 3.0, 50),
                                                        dtype=torch.float32, device=device)),
                    config=RasterConfig(capacity=1 << 15))
    s.orbit.width, s.orbit.height, s.orbit.radius = 96, 64, 3.0
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("feature_dim", [16, 32])
def test_session_on_card_matches_cpu(cuda, feature_dim):
    """One session on the card (the forward kernel at C = 3 and at
    C = feature_dim) and on the CPU (the plain blend): frames and feature
    maps to the kernel's 1e-4, the prompt and the score map to 1e-4, the 3D
    mask equal away from the threshold, undo exact, cluster labels equal
    away from ties with the same subsample and centers.  The PCA preview to
    1e-3 up to sign: an SVD of maps that differ by 1e-4."""
    cpu, card = _session(torch.device("cpu"), feature_dim), _session(cuda, feature_dim)
    fwd = dict(blend_cuda.FORWARD.launches_by_channels)
    np.testing.assert_allclose(card.render_rgb(), cpu.render_rgb(), atol=1e-4, rtol=0)
    fmap_cpu = cpu.render_feature_map()
    torch.testing.assert_close(card.render_feature_map().cpu(), fmap_cpu, atol=1e-4, rtol=0)
    pca_cpu, pca_card = cpu.render_pca(), card.render_pca()
    for c in range(3):
        err = min(np.abs(pca_card[..., c] - pca_cpu[..., c]).max(),
                  np.abs(pca_card[..., c] - 1 + pca_cpu[..., c]).max())
        assert err <= 1e-3, (c, err)
    norm = fmap_cpu.norm(dim=-1)
    y, x = (int(v) for v in torch.nonzero(norm == norm.max())[0])
    for s in (cpu, card):
        s.click(x, y)
    torch.testing.assert_close(card.chosen_features[0].cpu(), cpu.chosen_features[0],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(card.render_similarity(), cpu.render_similarity(), atol=1e-4,
                               rtol=0)
    torch.cuda.synchronize()
    launched = {k: v - fwd[k] for k, v in blend_cuda.FORWARD.launches_by_channels.items()}
    assert launched[3] == 1 and launched[blend_cuda.instance_channels(feature_dim)] == 4

    from seganygaussians_torch.models import feature_gaussians as fgm
    from seganygaussians_torch.seg import queries

    gated = queries.gate_features(fgm.smoothed_point_features(cpu.feature_state), cpu.gate,
                                  cpu.scale)
    score = queries.similarity_to_prompts(gated, torch.stack(cpu.chosen_features)).numpy()
    live = np.sort(score)
    mid = slice(len(live) // 4, 3 * len(live) // 4)
    i = int(np.argmax(np.diff(live[mid]))) + mid.start
    cpu.threshold = card.threshold = float(0.5 * (live[i] + live[i + 1]))
    before = card.scene_state.alive.clone()
    got, want = card.segment3d().cpu().numpy(), cpu.segment3d().numpy()
    far = np.concatenate([np.abs(score - cpu.threshold) > 1e-4, np.ones(84, bool)])
    np.testing.assert_array_equal(got[far], want[far])
    assert 0 < want.sum() < 300
    for s in (cpu, card):
        s.roll_back()
    assert torch.equal(card.scene_state.alive, before)

    idx = torch.tensor(np.random.default_rng(1).choice(300, 16, replace=False))
    init = gated[idx[:4]]
    cpu.cluster_in_3d(k=4, indices=idx, init_centers=init)
    card.cluster_in_3d(k=4, indices=idx, init_centers=init.to(cuda))
    torch.testing.assert_close(card.cluster_centers.cpu(), cpu.cluster_centers, atol=1e-4,
                               rtol=0)
    palette = np.eye(4, 3)
    a, b = card.render_cluster(palette=palette), cpu.render_cluster(palette=palette)
    assert (a == b).all(axis=-1).mean() > 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("factor", [1, 2, 2.6, 4, 0.5])
def test_resize_and_erosion_on_card_match_cpu(cuda, factor):
    """``resize_bilinear`` (``antialias=True``, another implementation on
    CUDA) at the CPU test's factors, to 1e-5; the erosion equal wherever the
    window sum lies more than 1e-5 from 2."""
    from seganygaussians_torch.preprocess import box_sum_3x3
    from seganygaussians_torch.seg import language

    rng = np.random.default_rng(3)
    h, w = 52, 84
    out = (int(h / factor), int(w / factor))
    ys, xs = np.mgrid[:h, :w]
    masks = np.stack([(xs - rng.uniform(0, w)) ** 2 + (ys - rng.uniform(0, h)) ** 2
                      < rng.uniform(100, 600) for _ in range(4)]).astype(np.float32)
    fmap = rng.normal(size=(32, h, w)).astype(np.float32)
    for x in (masks, fmap):
        torch.testing.assert_close(language.resize_bilinear(torch.tensor(x).to(cuda), out).cpu(),
                                   language.resize_bilinear(torch.tensor(x), out),
                                   atol=1e-5, rtol=0)
    window = box_sum_3x3(language.resize_bilinear(torch.tensor(masks), out))
    far = (window - 2.0).abs() > 1e-5
    got = language.erode_masks(torch.tensor(masks).to(cuda), out).cpu()
    assert torch.equal(got[far], language.erode_masks(torch.tensor(masks), out)[far])


@pytest.mark.cuda
def test_segment3d_and_text_segment_on_card_match_cpu(cuda):
    """``queries.segment3d`` and one ``language.text_segment`` (given
    anchors) on the card against the CPU: equal masks away from the
    thresholds, equal cluster labels."""
    from seganygaussians_torch.ops.quantile import fit_quantile_transform
    from seganygaussians_torch.seg import language, queries
    from seganygaussians_torch.seg.scale_gate import ScaleGateParams

    rng = np.random.default_rng(4)
    n, d, h, w = 400, 32, 30, 45
    dirs = rng.normal(size=(3, d))
    obj = rng.integers(0, 3, n)
    feats = torch.tensor(dirs[obj] + 0.35 * rng.normal(size=(n, d)), dtype=torch.float32)
    gate = ScaleGateParams(torch.tensor(rng.normal(0, 0.5, (1, d)), dtype=torch.float32),
                           torch.tensor(rng.normal(1.5, 0.5, d), dtype=torch.float32))
    prompts = feats[[3, 50]] + 0.1

    def on(dev):
        return (feats.to(dev), ScaleGateParams(gate.w.to(dev), gate.b.to(dev)))

    gated = queries.gate_features(feats, gate, 0.4)
    score = queries.similarity_to_prompts(gated, queries.normalize(prompts))
    far = (score - 0.75).abs() > 1e-5
    masks = {str(dev): queries.segment3d(*on(dev), 0.4, prompts.to(dev), 0.75).cpu()
             for dev in ("cpu", cuda)}
    assert torch.equal(masks[str(cuda)][far], masks["cpu"][far])

    class View:
        pass

    views = []
    for v in range(3):
        band = np.repeat(rng.permutation(3), w // 3 + 1)[:w]
        fmap = dirs[band][None].repeat(h, 0) + 0.3 * rng.normal(size=(h, w, d))
        view = View()
        view.fmap = (fmap / np.linalg.norm(fmap, axis=-1, keepdims=True)).astype(np.float32)
        view.sam_masks = np.stack([np.broadcast_to(band == o, (h, w)) for o in range(3)]
                                  + [np.ones((h, w), bool)])
        view.mask_scales = np.array([0.5, 0.6, 0.7, 2.0], np.float32)
        view.clip_features = np.eye(4, 8, dtype=np.float32) + 0.05 * rng.normal(size=(4, 8))
        views.append(view)
    qt = fit_quantile_transform(torch.tensor(np.concatenate([v.mask_scales for v in views])))
    anchors = torch.tensor(rng.choice(n, 20, replace=False))
    res = {}
    for dev in ("cpu", cuda):
        f, g = on(dev)
        res[str(dev)] = language.text_segment(
            lambda v: torch.tensor(v.fmap, device=dev), views, f, g,
            qt._replace(quantiles=qt.quantiles.to(dev)), lambda e: np.asarray(e)[:, 1],
            anchor_indices=anchors, min_cluster_size=2, downsample=2)
    a, b = res[str(cuda)], res["cpu"]
    np.testing.assert_array_equal(a.labels, b.labels)
    np.testing.assert_allclose(a.scores, b.scores, atol=1e-6, rtol=0)
    assert torch.equal(a.mask3d.cpu(), b.mask3d)
    assert 0 < int(b.mask3d.sum()) < n
