"""Port parity: the parallel layer on ``torch.distributed``.

One ``torch.multiprocessing.spawn`` of two gloo ranks runs every step of the
layer on the CPU: the scene data-parallel step, the contrastive step on
("data", "ray") meshes of (2, 1) and (1, 2), the tile-sharded render and
loss gradient, the dry run, and the mesh's checks.  Each rank writes its
results to a temporary folder that a module-scoped fixture reads.  The tests
hold them against the port's single-process sequential steps, the same steps
run in turn in this process (``mesh.run_in_turn``), and the JAX package's
steps on a 2-device CPU mesh, on the same seeded numpy inputs, at the JAX
package's own tolerances (``tests/test_parallel.py``): ``xyz`` after one
step 1e-6; contrastive gradients 1e-6 + 1e-4 of their largest value; the
tile-sharded image 2e-5 and its gradients 1e-6.  The contrastive steps take
the JAX steps' random draws.
"""

import os
import socket

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from seganygaussians_tpu.models import gaussians as jgm
from seganygaussians_tpu.models import optim as joptim
from seganygaussians_tpu.ops.camera import make_camera as jmake_camera
from seganygaussians_tpu.ops.rasterize import RasterConfig as JRasterConfig
from seganygaussians_tpu.parallel import make_mesh as jmake_mesh
from seganygaussians_tpu.parallel.contrastive_dp import make_dp_contrastive_step as jdp_contrastive
from seganygaussians_tpu.parallel.contrastive_dp import stack_bundles as jstack_bundles
from seganygaussians_tpu.parallel.data_parallel import make_dp_train_step as jdp_train
from seganygaussians_tpu.parallel.data_parallel import stack_cameras as jstack_cameras
from seganygaussians_tpu.parallel.tile_sharded import make_tile_sharded_loss_grad as jtile_grad
from seganygaussians_tpu.parallel.tile_sharded import make_tile_sharded_render as jtile_render
from seganygaussians_tpu.train import contrastive_trainer as jct
from seganygaussians_torch.models import feature_gaussians as tfgm
from seganygaussians_torch.models import gaussians as tgm
from seganygaussians_torch.models import optim as toptim
from seganygaussians_torch.ops import losses as tlosses
from seganygaussians_torch.ops.camera import make_camera
from seganygaussians_torch.ops.quantile import QuantileTransform
from seganygaussians_torch.ops.rasterize import RasterConfig, rasterize
from seganygaussians_torch.parallel import contrastive_dp, data_parallel, tile_sharded
from seganygaussians_torch.parallel.mesh import Layout
from seganygaussians_torch.seg.scale_gate import ScaleGateParams
from seganygaussians_torch.train import contrastive_trainer as tct
from tests.test_parallel import _contrastive_setup

WORLD = 2
DP_CAMS = [dict(R=np.eye(3), t=np.array([0.1 * i, 0.0, 0.0]), fovx=0.9, fovy=0.7, width=32,
                height=32) for i in range(WORLD)]
FEAT_CAM = dict(R=np.eye(3), t=np.zeros(3), fovx=1.1, fovy=0.9, width=32, height=24)
TILE_CAMS = {"render": dict(R=np.eye(3), t=np.zeros(3), fovx=1.1, fovy=0.9, width=96,
                            height=80),
             "grad": dict(R=np.eye(3), t=np.zeros(3), fovx=1.1, fovy=0.9, width=80, height=64)}
RAYS = 64
MESHES = {"2x1": (2, 1), "1x2": (1, 2)}
KEYS = {"2x1": (1, 2), "1x2": (42,)}  # one PRNG key per camera


def _tree(x):
    """NamedTuples of arrays as nested dicts of numpy arrays (picklable
    without the JAX package)."""
    if hasattr(x, "_asdict"):
        return {k: _tree(v) for k, v in x._asdict().items()}
    return None if x is None else np.asarray(x)


def _dp_scene():
    rng = np.random.default_rng(0)
    n = 32
    pts = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
                    3 + rng.uniform(-0.3, 0.3, n)], 1).astype(np.float32)
    state = jgm.create_from_points(pts, rng.uniform(size=(n, 3)).astype(np.float32), 0, 64)
    gts = rng.uniform(size=(WORLD, 32, 32, 3)).astype(np.float32)
    return state, gts


def _tile_scene(kind):
    """``tests/test_parallel.py``'s tile-sharded scenes."""
    rng = np.random.default_rng(0)
    n = 300 if kind == "render" else 250
    pts = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.8, 0.8, n),
                    rng.uniform(2.0, 6.0, n)], 1).astype(np.float32)
    scales = rng.uniform(0.02, 0.18, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.uniform(0.1, 0.95, n).astype(np.float32)
    cols = rng.random((n, 3)).astype(np.float32)
    bg = (np.array([0.1, 0.2, 0.3]) if kind == "render" else np.zeros(3)).astype(np.float32)
    cam = TILE_CAMS[kind]
    gt = rng.random((cam["height"], cam["width"], 3)).astype(np.float32)
    return dict(means=pts, opac=opac, cols=cols, scales=scales, quats=quats, bg=bg, gt=gt)


def _contrastive_inputs(setup):
    """The JAX setup as numpy, the masks rebuilt for the port, and the JAX
    steps' draws for each mesh."""
    from tests.test_torch_contrastive import replay_draws

    fs, gate, _, bundle, consts = setup
    hyper = jct.ContrastiveHyper(num_sampled_rays=RAYS, smooth_dropout=-1.0, debug_grads=True)
    draws = {name: [{k: None if v is None else v.numpy()
                     for k, v in replay_draws(jax.random.PRNGKey(key), bundle, hyper)
                     ._asdict().items()} for key in keys]
             for name, keys in KEYS.items()}
    return dict(fs=_tree(fs), gate=_tree(gate), masks=np.asarray(bundle.masks),
                mask_scales=np.asarray(bundle.scales), n_valid=int(bundle.n_valid),
                quantiles=np.asarray(consts.qt.quantiles), draws=draws)


def _port_contrastive(inputs):
    fs = tfgm.feature_state_from_jax(inputs["fs"], device="cpu")
    gate = ScaleGateParams(*(torch.tensor(inputs["gate"][k]) for k in ("w", "b")))
    k = inputs["n_valid"]
    bundle = tct.build_mask_bundle(inputs["masks"][:k] > 0, inputs["mask_scales"][:k],
                                   inputs["masks"].shape[0], device="cpu")
    consts = tct.ContrastiveConsts(upper_bound_scale=torch.tensor(5.0),
                                   qt=QuantileTransform(torch.from_numpy(inputs["quantiles"]),
                                                        False))
    hyper = tct.ContrastiveHyper(num_sampled_rays=RAYS, smooth_dropout=-1.0, debug_grads=True)
    return fs, gate, bundle, consts, hyper


def _draws(d):
    return tct.StepDraws(**{k: None if v is None else torch.from_numpy(v) for k, v in d.items()})


def _port_runs(mesh_for, inputs):
    """Every step of the layer over meshes from ``mesh_for(names, shape)``;
    returns the results the tests compare (CPU tensors)."""
    out = {}
    state = tgm.from_jax_state(inputs["dp_state"], device="cpu")
    cams = [make_camera(**c) for c in DP_CAMS]
    batch, template = data_parallel.stack_cameras(cams)
    step = data_parallel.make_dp_train_step(mesh_for(("data",), (WORLD,)), template,
                                            tgm.TrainHyper(), RasterConfig(capacity=1 << 12),
                                            2.0, 0, debug_grads=True)
    new, loss, overflow, grads = step(state, batch, torch.from_numpy(inputs["dp_gts"]),
                                      torch.zeros(3), 1)
    out["dp"] = dict(xyz=new.params.xyz, opacity=new.params.opacity, loss=loss, grads=grads,
                     overflow=overflow, xyz_grad_accum=new.xyz_grad_accum, denom=new.denom,
                     max_radii2d=new.max_radii2d)

    fs, gate, bundle, consts, hyper = _port_contrastive(inputs["contrastive"])
    cam = make_camera(**FEAT_CAM)
    for name, shape in MESHES.items():
        draws = [_draws(d) for d in inputs["contrastive"]["draws"][name]]
        run = contrastive_dp.make_dp_contrastive_step(mesh_for(("data", "ray"), shape), cam,
                                                      hyper, RasterConfig(capacity=1 << 11))
        res = run(fs, gate, toptim.adam_init(gate), [cam] * shape[0],
                  contrastive_dp.stack_bundles([bundle] * shape[0]), consts, draws)
        out[name] = dict(loss=res[3], grads=res[5], overflow=res[4],
                         features=res[0].point_features)

    for kind, fn in (("render", tile_sharded.make_tile_sharded_render),
                     ("grad", tile_sharded.make_tile_sharded_loss_grad)):
        s = {k: torch.from_numpy(v) for k, v in inputs[kind].items()}
        run = fn(mesh_for(("tiles",), (WORLD,)), "tiles", make_camera(**TILE_CAMS[kind]),
                 RasterConfig(capacity=1 << 13))
        args = (s["means"], s["opac"], s["cols"], s["scales"], s["quats"], s["bg"])
        if kind == "render":
            img, overflow = run(*args)
            out["render"] = dict(img=img, overflow=overflow)
        else:
            (loss, overflow), grads = run(*args, s["gt"])
            out["grad"] = dict(loss=loss, overflow=overflow, grads=grads)
    return out


def _worker(rank, port, inputs, folder):
    from seganygaussians_torch.parallel import dryrun
    from seganygaussians_torch.parallel.mesh import initialize_distributed, make_mesh

    torch.set_num_threads(1)
    initialize_distributed("cpu", init_method=f"tcp://localhost:{port}", world_size=WORLD,
                           rank=rank, timeout_s=60)
    try:
        out = _port_runs(lambda names, shape: make_mesh(WORLD, names, shape), inputs)
        out["dryrun"] = dryrun.dryrun(torch.device("cpu"))
        out["mesh"] = [tuple(make_mesh(WORLD, ("data", "ray"), s).mesh.shape)
                       for s in ((1, 2), None)]
        errors = []
        for bad in (dict(n_devices=3), dict(axis_names=("data", "ray"), axis_shape=(2, 2)),
                    dict(axis_names=("data", "ray"), axis_shape=(2,))):
            try:
                make_mesh(**bad)
            except ValueError as e:
                errors.append(str(e))
        out["mesh_errors"] = errors
        torch.save(out, os.path.join(folder, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def jax_inputs():
    """The JAX package's states, made once (its steps get copies: they
    donate their inputs)."""
    return dict(dp=_dp_scene(), contrastive=_contrastive_setup())


def _copy(tree):
    return jax.tree_util.tree_map(jnp.copy, tree)


@pytest.fixture(scope="module")
def inputs(jax_inputs):
    state, gts = jax_inputs["dp"]
    return dict(dp_state=_tree(state), dp_gts=gts,
                contrastive=_contrastive_inputs(jax_inputs["contrastive"]),
                render=_tile_scene("render"), grad=_tile_scene("grad"))


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("parallel"))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.multiprocessing.spawn(_worker, args=(port, inputs, folder), nprocs=WORLD, join=True)
    return [torch.load(os.path.join(folder, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def in_turn(inputs):
    return _port_runs(lambda names, shape: Layout(names, shape), inputs)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def test_ranks_agree_and_match_the_steps_run_in_turn(ranks, in_turn):
    """Every rank ends with the same replicated result, and the gloo run is
    the in-turn run: the collectives compute the same sums."""
    for name, res in ranks[0].items():
        if name in ("dryrun", "mesh", "mesh_errors"):
            continue
        for key, value in res.items():
            for other in (ranks[1][name][key], in_turn[name][key]):
                if isinstance(value, tuple):
                    for a, b in zip(value, other):
                        _close(a, b, 1e-6)
                elif isinstance(value, torch.Tensor):
                    _close(value, other, 1e-6)
                else:
                    assert value == other, (name, key)


def test_dp_scene_step_matches_sequential_and_jax(ranks, inputs, jax_inputs):
    """The averaged parameter gradients against the mean of the per-camera
    gradients, within 1e-6 of each tensor's largest; xyz and opacity after
    one 2-camera step: the mean of the per-camera gradients, one Adam update
    (the port alone, sequentially) and the JAX package's 2-device step,
    within 1e-6; the densification statistics as over two sequential
    iterations."""
    got = ranks[0]["dp"]
    state = tgm.from_jax_state(inputs["dp_state"], device="cpu")
    hyper = tgm.TrainHyper()
    cams = [make_camera(**c) for c in DP_CAMS]
    grads, accum, denom, radii = [], 0, 0, state.max_radii2d
    for cam, gt in zip(cams, inputs["dp_gts"]):
        leaves = [p.detach().requires_grad_(True) for p in state.params]
        p = tgm.GaussianParams(*leaves)
        ndc = torch.zeros((64, 2), requires_grad=True)
        out = rasterize(p.xyz, tgm.get_opacity(p)[:, 0], cam, shs=tgm.get_shs(p), sh_degree=0,
                        scales=tgm.get_scaling(p), rotations=tgm.get_rotation(p),
                        bg=torch.zeros(3), ndc_offset=ndc, active_mask=state.alive,
                        config=RasterConfig(capacity=1 << 12))
        gt = torch.from_numpy(gt)
        loss = ((1 - hyper.lambda_dssim) * tlosses.l1_loss(out.color, gt)
                + hyper.lambda_dssim * (1 - tlosses.ssim(out.color, gt)))
        *g, g_ndc = torch.autograd.grad(loss, leaves + [ndc])
        grads.append(g)
        visible = out.radii > 0
        accum = accum + torch.where(visible, g_ndc.norm(dim=-1), 0.0)
        denom = denom + visible.float()
        radii = torch.maximum(radii, out.radii.float())
    mean = tgm.GaussianParams(*((a + b) / 2 for a, b in zip(*grads)))
    want, _ = toptim.adam_update(mean, state.opt, state.params, tgm.make_lr_tree(hyper, 2.0, 1))
    for g, m in zip(got["grads"], mean):
        _close(g, m, 1e-6 * float(m.abs().max()) if m.numel() else 0)
    _close(got["xyz"], want.xyz, 1e-6)
    _close(got["opacity"], want.opacity, 1e-6)
    _close(got["xyz_grad_accum"], accum, 1e-6)
    assert torch.equal(got["denom"], denom) and torch.equal(got["max_radii2d"], radii)
    assert not got["overflow"] and float(got["loss"]) > 0

    jstate, gts = _copy(jax_inputs["dp"][0]), jax_inputs["dp"][1]
    jcams = [jmake_camera(**c) for c in DP_CAMS]
    batch, template = jstack_cameras(jcams)
    step = jdp_train(jmake_mesh(WORLD), template, jgm.TrainHyper(),
                     JRasterConfig(capacity=1 << 12, backend="xla"), 2.0, 0)
    jnew, jloss, _ = step(jstate, batch, jnp.asarray(gts), jnp.zeros(3), jnp.asarray(1))
    _close(got["xyz"], jnew.params.xyz, 1e-6)
    _close(got["opacity"], jnew.params.opacity, 1e-6)
    _close(got["loss"], jloss, 1e-6)


@pytest.mark.parametrize("name", list(MESHES))
def test_dp_contrastive_matches_sequential_and_jax(ranks, inputs, jax_inputs, name):
    """The feature gradients of the (data, ray) step: the mean over cameras
    of the single-camera step's (``contrastive_step`` on the same draws) and
    the JAX package's step on a 2-device mesh, within 1e-6 + 1e-4 of their
    largest value; the loss within 1e-5."""
    got = ranks[0][name]
    c = inputs["contrastive"]
    fs, gate, bundle, consts, hyper = _port_contrastive(c)
    cam = make_camera(**FEAT_CAM)
    seq = [tct.contrastive_step(fs, gate, toptim.adam_init(gate), cam, bundle, consts, hyper,
                                RasterConfig(capacity=1 << 11), draws=_draws(d))[3]
           for d in c["draws"][name]]
    want = sum(a["feat_grads"] for a in seq) / len(seq)
    tol = 1e-6 + 1e-4 * float(want.abs().max())
    _close(got["grads"], want, tol)
    _close(got["loss"], sum(float(a["loss"]) for a in seq) / len(seq), 1e-5)

    jfs, jgate, jcam, jbundle, jconsts = _copy(jax_inputs["contrastive"])
    shape = MESHES[name]
    jhyper = jct.ContrastiveHyper(num_sampled_rays=RAYS, smooth_dropout=-1.0, debug_grads=True)
    step = jdp_contrastive(jmake_mesh(WORLD, ("data", "ray"), shape), jcam, jhyper,
                           JRasterConfig(capacity=1 << 11, backend="xla"))
    keys = jnp.stack([jax.random.PRNGKey(k) for k in KEYS[name]])
    *_, jloss, _, jgrads = step(jfs, jgate, joptim.adam_init(jgate), [jcam] * shape[0],
                                jstack_bundles([jbundle] * shape[0]), jconsts, keys)
    _close(got["grads"], jgrads, tol)
    _close(got["loss"], jloss, 1e-5)
    assert not got["overflow"]


def test_tile_sharded_render_matches_whole_frame_and_jax(ranks, inputs):
    got = ranks[0]["render"]
    s = inputs["render"]
    cam = TILE_CAMS["render"]
    want = rasterize(*(torch.from_numpy(s[k]) for k in ("means", "opac")), make_camera(**cam),
                     colors=torch.from_numpy(s["cols"]), scales=torch.from_numpy(s["scales"]),
                     rotations=torch.from_numpy(s["quats"]), bg=torch.from_numpy(s["bg"]),
                     config=RasterConfig(capacity=1 << 13))
    assert got["img"].shape == (cam["height"], cam["width"], 3) and not got["overflow"]
    _close(got["img"], want.color, 2e-5)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("tiles",))
    render = jtile_render(mesh, "tiles", jmake_camera(**cam),
                          JRasterConfig(capacity=1 << 13, backend="xla"), backend="xla")
    jimg, _ = jax.jit(render)(*(jnp.asarray(s[k]) for k in ("means", "opac", "cols", "scales",
                                                             "quats", "bg")))
    _close(got["img"], jimg, 2e-5)


def test_tile_sharded_grad_matches_whole_frame_and_jax(ranks, inputs):
    """The slabs' summed loss and gradients against the whole frame's
    (``rasterize`` and autograd) and the JAX package's slab step, 1e-6."""
    got = ranks[0]["grad"]
    s = inputs["grad"]
    cam = TILE_CAMS["grad"]
    leaves = [torch.from_numpy(s[k]).requires_grad_(True)
              for k in ("means", "opac", "cols", "scales", "quats")]
    out = rasterize(leaves[0], leaves[1], make_camera(**cam), colors=leaves[2],
                    scales=leaves[3], rotations=leaves[4], bg=torch.from_numpy(s["bg"]),
                    config=RasterConfig(capacity=1 << 13))
    loss = torch.mean(torch.abs(out.color - torch.from_numpy(s["gt"])))
    want = torch.autograd.grad(loss, leaves)
    assert abs(float(got["loss"]) - float(loss.detach())) < 1e-6 and not got["overflow"]
    for a, b in zip(got["grads"], want):
        _close(a, b, 1e-6)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("tiles",))
    lg = jtile_grad(mesh, "tiles", jmake_camera(**cam),
                    JRasterConfig(capacity=1 << 13, backend="xla"), backend="xla")
    (jloss, _), jgrads = lg(*(jnp.asarray(s[k]) for k in ("means", "opac", "cols", "scales",
                                                           "quats", "bg", "gt")))
    assert abs(float(got["loss"]) - float(jloss)) < 1e-6
    for a, b in zip(got["grads"], jgrads):
        _close(a, b, 1e-6)


def test_dryrun_and_mesh_checks(ranks):
    """The dry run prints its three lines on two ranks; ``make_mesh`` keeps
    the JAX function's shapes and checks."""
    lines = ranks[0]["dryrun"]
    assert [ln.split(" ok:")[0] for ln in lines] == [
        f"dryrun({WORLD}) {step}" for step in ("scene-dp", "contrastive-dp", "tile-sharded")]
    assert ranks[0]["mesh"] == [(1, 2), (2, 1)]
    assert [e.split(" ")[0] for e in ranks[0]["mesh_errors"]] == ["want", "axis_shape",
                                                                  "axis_shape"]


def test_run_in_turn_refuses_mismatched_steps():
    from seganygaussians_torch.parallel.mesh import collective, run_in_turn

    def step(op):
        yield collective(op, "data", torch.ones(2))

    with pytest.raises(RuntimeError, match="different collectives"):
        run_in_turn({0: step("sum"), 1: step("max")}, Layout(("data",), (2,)))
    with pytest.raises(ValueError, match="one step per rank"):
        run_in_turn({0: step("sum")}, Layout(("data",), (2,)))

