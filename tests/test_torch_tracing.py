"""The port's spans and counters (``utils/tracing.py``) on the CPU.

Each test runs a tiny scene step, contrastive step or session request.  Off
(no profiler), tracing enters no ``record_function``, records nothing and
adds no autograd node.  On, every op launched from a function of a module in
``perfbench/layers.json`` sits under a ``saga:<layer>`` span of that module's
layer (the unit spans are the ``entry`` layer's), unit spans carry their ids,
the backward's marks fire once a step, image first, the slot counters are
the binning plan's, and a multi-resolution step records one span and one row
count a level.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench.trace import layer_spans
from seganygaussians_torch.models import feature_gaussians as fgm
from seganygaussians_torch.models import gaussians as gm
from seganygaussians_torch.ops import binning
from seganygaussians_torch.ops.camera import make_camera
from seganygaussians_torch.ops.rasterize import RasterConfig
from seganygaussians_torch.seg.scale_gate import ScaleGateParams
from seganygaussians_torch.train import scene_trainer
from seganygaussians_torch.train.contrastive_trainer import ContrastiveHyper, ContrastiveTrainer
from seganygaussians_torch.utils import tracing
from seganygaussians_torch.viewer.interactive import SagaSession

LAYERS = os.path.join(os.path.dirname(__file__), "..", "perfbench", "layers.json")
W, H, N, D = 32, 24, 40, 8
CONFIG = RasterConfig(tile_size=8, capacity=1 << 12)
UNITS = ("scene_step", "feature_step")  # and request.*: the entry layer's spans


def camera():
    return make_camera(np.eye(3), np.zeros(3), fovx=1.0, fovy=0.8, width=W, height=H)


def scene_state(seed=0):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.uniform(-0.8, 0.8, (N, 2)), rng.uniform(2.5, 3.5, (N, 1))], 1)
    cols = rng.uniform(0.1, 0.9, (N, 3))
    state = gm.create_from_points(pts.astype(np.float32), cols.astype(np.float32),
                                  sh_degree=1, capacity=N + 8, device="cpu")
    # Larger footprints, so that the small frame is covered.
    p = state.params._replace(scaling=state.params.scaling + 1.0,
                              opacity=torch.full_like(state.params.opacity, 1.0))
    return state._replace(params=p)


def feature_state(state, seed=0):
    g = torch.Generator().manual_seed(seed)
    p = state.params
    geom = fgm.FrozenGeometry(xyz=p.xyz, scaling=p.scaling, rotation=p.rotation,
                              opacity=p.opacity, alive=state.alive)
    feats = torch.randn(p.xyz.shape[0], D, generator=g)
    return fgm.FeatureState(geom=geom, point_features=feats,
                            smooth_map=fgm.build_smooth_map(p.xyz, 4),
                            opt=gm.optim.adam_init(fgm.FeatureParams(feats)))


def gate(seed=0):
    g = torch.Generator().manual_seed(seed)
    return ScaleGateParams(w=torch.rand(1, D, generator=g), b=torch.rand(D, generator=g))


def scene_trainer_of(state):
    rng = np.random.default_rng(1)
    cams = [SimpleNamespace(params=camera(), image=rng.uniform(size=(H, W, 3)).astype(np.float32),
                            image_name=f"v{i}") for i in range(2)]
    return scene_trainer.SceneTrainer(gm.with_training_fields(state), cams,
                                      spatial_lr_scale=1.0, sh_degree=1, config=CONFIG, seed=3)


def contrastive_trainer_of(state, smooth_type="traditional"):
    rng = np.random.default_rng(2)
    cams = []
    for i in range(2):
        masks = np.zeros((3, H, W), bool)
        masks[0, :, : W // 2] = masks[1, : H // 2] = masks[2, 4:12, 4:12] = True
        cams.append(SimpleNamespace(params=camera(), sam_masks=masks,
                                    mask_scales=rng.uniform(0.1, 1.0, 3).astype(np.float32)))
    hyper = ContrastiveHyper(num_sampled_rays=16, smooth_k=4, smooth_dropout=0.5,
                             smooth_type=smooth_type)
    return ContrastiveTrainer(feature_state(state), gate(), cams, hyper=hyper, config=CONFIG,
                              seed=5)


def session_of(state):
    return SagaSession(state, feature_state(state), gate(), None, config=CONFIG, seed=1)


def serve(session):
    session.click(W // 2, H // 2, cam=camera())
    session.render_similarity(camera())
    session.segment3d()
    session.roll_back()


def profiled(run):
    """Run ``run()`` under the profiler with the benchmark's layer spans;
    returns the CPU events and the tracing summary."""
    table = json.loads(open(LAYERS).read())
    with layer_spans(table), profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    return list(prof.events()), tracing.summary()


# --------------------------------------------------------------------------
# Off
# --------------------------------------------------------------------------


class Entered:
    """Counts every ``record_function`` entered and every CUDA event made."""

    def __init__(self, monkeypatch):
        self.spans = self.events = 0
        real = torch.autograd.profiler.record_function

        def counting(*a, **k):
            self.spans += 1
            return real(*a, **k)

        def event(*a, **k):
            self.events += 1
            raise AssertionError("a CUDA event with tracing off")

        monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
        monkeypatch.setattr(torch.cuda, "Event", event)


def graph_nodes(t):
    seen, todo, names = set(), [t.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo.extend(f for f, _ in fn.next_functions)
    return names


@pytest.mark.parametrize("unit", ["scene", "feature", "serve"])
def test_off_enters_no_span_and_records_nothing(unit, monkeypatch):
    state = scene_state()
    tracing.reset()
    seen = Entered(monkeypatch)
    if unit == "scene":
        scene_trainer_of(state).run(iterations=2)
    elif unit == "feature":
        contrastive_trainer_of(state).run(iterations=2)
    else:
        serve(session_of(state))
    assert not torch.autograd.profiler._is_profiler_enabled
    assert (seen.spans, seen.events) == (0, 0)
    s = tracing.summary()
    assert s["spans"] == {} and s["segments"] == {} and s["counters"] == {}


def test_off_train_step_graph_holds_no_mark():
    state = gm.with_training_fields(scene_state())
    leaves = [p.detach().requires_grad_(True) for p in state.params]
    out = scene_trainer._render(gm.GaussianParams(*leaves), state.alive, camera(),
                                torch.zeros(3), 1, CONFIG)
    names = graph_nodes(out.color.sum())
    assert names and not any("Mark" in n for n in names)
    # On, the same render holds both edges.
    with profile(activities=[ProfilerActivity.CPU]):
        out = scene_trainer._render(gm.GaussianParams(*leaves), state.alive, camera(),
                                    torch.zeros(3), 1, CONFIG)
    assert sum("Mark" in n for n in graph_nodes(out.color.sum())) == 2


def test_marks_leave_the_gradients_as_they_were():
    state = gm.with_training_fields(scene_state())
    gt = torch.rand(H, W, 3, generator=torch.Generator().manual_seed(0))
    hyper = gm.TrainHyper()
    off = scene_trainer.view_loss_and_grads(state, camera(), gt, torch.zeros(3), 1, hyper, CONFIG)
    with profile(activities=[ProfilerActivity.CPU]):
        on = scene_trainer.view_loss_and_grads(state, camera(), gt, torch.zeros(3), 1, hyper,
                                               CONFIG)
    assert torch.equal(off[0], on[0])
    for a, b in zip(off[2] + [off[3]], on[2] + [on[3]]):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# On
# --------------------------------------------------------------------------


def _layer_of(e, layers):
    """(innermost ``layer:`` span, innermost ``saga:`` span of a layer or a
    unit) above a CPU event; None where the engine runs it."""
    bench = mine = None
    p = e.cpu_parent
    while p is not None:
        if p.name.startswith("autograd::engine::evaluate_function"):
            return None
        if bench is None and p.name.startswith("layer:"):
            bench = p.name[len("layer:"):]
        if mine is None and p.name.startswith(tracing.PREFIX):
            name = p.name[len(tracing.PREFIX):]
            if name in layers:
                mine = name
            elif name in UNITS or name.startswith("request."):
                mine = "entry"
        p = p.cpu_parent
    return bench, mine


@pytest.mark.parametrize("unit", ["scene", "feature", "serve"])
def test_every_layer_op_sits_under_its_layers_span(unit):
    state = scene_state()
    layers = set(json.loads(open(LAYERS).read())["modules"].values())
    if unit == "scene":
        tr = scene_trainer_of(state)
        events, _ = profiled(lambda: tr.run(iterations=2))
    elif unit == "feature":
        tr = contrastive_trainer_of(state)
        events, _ = profiled(lambda: tr.run(iterations=2))
    else:
        session = session_of(state)
        events, _ = profiled(lambda: serve(session))
    checked, wrong = 0, []
    for e in events:
        if not e.name.startswith("aten::"):
            continue
        got = _layer_of(e, layers)
        if got is None or got[0] is None:
            continue  # the engine's, or outside every function of a layer's module
        checked += 1
        if got[0] != got[1]:
            wrong.append((e.name, got))
    assert checked > 50
    assert not wrong, sorted(set(wrong))[:20]


def test_unit_spans_carry_their_ids():
    state = scene_state()
    tr = scene_trainer_of(state)
    tr.run(iterations=2)
    _, s = profiled(lambda: tr.run(iterations=5, start_iteration=2))
    assert s["spans"]["scene_step"]["uids"] == [3, 4, 5]
    assert s["spans"]["scene_step"]["count"] == 3
    # Nested spans inherit their unit's id.
    assert s["spans"]["binning"]["uids"] == [3, 4, 5]

    ct = contrastive_trainer_of(state)
    _, s = profiled(lambda: ct.run(iterations=2))
    assert s["spans"]["feature_step"]["uids"] == [1, 2]

    session = session_of(state)
    _, s = profiled(lambda: serve(session))
    spans = s["spans"]
    # One request id a public call, shared by what it calls.
    assert spans["request.click"]["uids"] == [1]
    assert spans["request.render_similarity"]["uids"] == [2]
    assert spans["request.render_feature_map"]["uids"] == [1, 2]
    assert spans["request.segment3d"]["uids"] == [3]
    assert spans["request.roll_back"]["uids"] == [4]
    for e in s["spans"].values():
        assert e["device_ms"] is None and e["host_ms"] >= e["self_host_ms"] >= 0


@pytest.mark.parametrize("unit", ["scene", "feature"])
def test_backward_edges_fire_once_a_step_image_first(unit):
    state = scene_state()
    if unit == "scene":
        tr = scene_trainer_of(state)
        events, s = profiled(lambda: tr.run(iterations=3))
        tail = "bwd.preprocess"
    else:
        tr = contrastive_trainer_of(state)
        events, s = profiled(lambda: tr.run(iterations=3))
        tail = "bwd.smoothing"
    fired = [e.name for e in sorted(events, key=lambda e: e.time_range.start)
             if e.name in ("saga:bwd.image", "saga:bwd.gaussians")]
    assert fired == ["saga:bwd.image", "saga:bwd.gaussians"] * 3
    assert set(s["segments"]) == {"bwd.loss", "bwd.raster", tail}
    for e in s["segments"].values():
        assert e["count"] == 3 and e["host_ms"] > 0 and e["device_ms"] is None
    assert s["spans"]["backward"]["count"] == 3


@pytest.mark.parametrize("smooth_type", ["multi_res", "traditional"])
def test_multi_res_levels_have_a_span_and_a_row_count_each(smooth_type):
    """A traced multi-resolution step records one span a level round its
    gather and mean, and counts each level's N·K_i neighbour rows and their
    sum; the K-neighbour smoothing records none of them."""
    tr = contrastive_trainer_of(scene_state(), smooth_type)
    _, s = profiled(lambda: tr.run(iterations=1))
    levels = {k: v["count"] for k, v in s["spans"].items() if k.startswith("smoothing.")}
    rows = {k: v for k, v in s["counters"].items() if k.startswith("smoothing.")}
    if smooth_type == "traditional":
        assert levels == {} and rows == {}
        return
    n = tr.feat_state.point_features.shape[0]
    assert [m.shape for m in tr.consts.multi_res_maps] == [(n, 4), (n, 4), (n, 16)]
    assert levels == {"smoothing.level0": 1, "smoothing.level1": 1, "smoothing.level2": 1}
    assert rows == {"smoothing.rows.level0": n * 4, "smoothing.rows.level1": n * 4,
                    "smoothing.rows.level2": n * 16, "smoothing.rows": n * (4 + 4 + 16)}
    assert s["spans"]["smoothing"]["host_ms"] >= sum(
        s["spans"][f"smoothing.level{i}"]["host_ms"] for i in range(3))


def test_slot_counters_are_the_plans(monkeypatch):
    plans = []
    real = binning.expand_slots

    def keep(*a, **k):
        plans.append(real(*a, **k))
        return plans[-1]

    state = scene_state()
    tr = scene_trainer_of(state)
    monkeypatch.setattr(scene_trainer, "rasterize", scene_trainer.rasterize)
    monkeypatch.setattr("seganygaussians_torch.ops.rasterize.expand_slots", keep)
    _, s = profiled(lambda: tr.run(iterations=2))
    assert len(plans) == 2
    c = s["counters"]
    assert c["raster.instances"] == sum(p.num_instances for p in plans) > 0
    assert c["raster.capacity"] == 2 * CONFIG.capacity
    assert c["raster.overflows"] == 0
    # A step: the instance count, the non-finite flag, the camera's three
    # matrices for the projection and three for SH, the NDC scale.
    sites = {"sync.binning": 2, "sync.nonfinite": 2, "sync.camera": 4, "sync.ndc_scale": 2}
    assert {k: v["count"] for k, v in s["spans"].items() if k.startswith("sync.")} == sites
    assert c["host_syncs"] == 2 + 2 + 3 * 4 + 2


def test_a_new_profiler_session_starts_an_empty_store():
    state = scene_state()
    tr = scene_trainer_of(state)
    _, first = profiled(lambda: tr.run(iterations=2))
    _, second = profiled(lambda: tr.run(iterations=3, start_iteration=2))
    assert first["spans"]["scene_step"]["count"] == 2
    assert second["spans"]["scene_step"]["count"] == 1
    assert second["counters"]["raster.capacity"] == CONFIG.capacity


def test_profile_window_writes_trace_and_spans(tmp_path):
    state = scene_state()
    tr = scene_trainer_of(state)
    window = tracing.ProfileWindow(str(tmp_path), first=2, count=3)
    tr.on_iteration = lambda _t, it, _m: window.after(it)
    tr.run(iterations=6)
    window.close()
    spans = json.loads((tmp_path / "spans.json").read_text())
    assert spans["spans"]["scene_step"]["uids"] == [3, 4, 5]
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "saga:scene_step" in names and "saga:binning" in names


def test_preprocess_kernels_launches_reach_spans_json(tmp_path, monkeypatch):
    """Once the preprocess kernels' module is loaded, ``_kernels`` lists its
    two counters beside the blend kernels', and a profiled window's
    ``spans.json`` carries their launches (kernels stood in by counters)."""
    from seganygaussians_torch.ops import blend_cuda, preprocess_cuda

    kernels = tracing._kernels()
    assert kernels["preprocess_fwd"] is preprocess_cuda.FORWARD
    assert kernels["preprocess_bwd"] is preprocess_cuda.BACKWARD
    assert kernels["blend_fwd"] is blend_cuda.FORWARD

    class Counting:
        def __init__(self, out):
            self.out, self.launches = out, 0

        def __call__(self, *args):
            self.launches += 1
            return self.out(*args)

    n = 4
    ints = (torch.zeros(n, dtype=torch.int32), torch.zeros(n, 2, dtype=torch.int32),
            torch.zeros(n, 2, dtype=torch.int32), torch.zeros(n, dtype=torch.int32),
            torch.ones(n, dtype=torch.bool))
    fwd = Counting(lambda m, *_: (m[:, :2] * 1.0, m[:, 2] * 1.0, m * 1.0, None) + ints)
    bwd = Counting(lambda m, *a: (torch.ones_like(m), None, None, None, None))
    monkeypatch.setattr(preprocess_cuda, "FORWARD", fwd)
    monkeypatch.setattr(preprocess_cuda, "BACKWARD", bwd)
    means = torch.ones(n, 3, requires_grad=True)
    window = tracing.ProfileWindow(str(tmp_path), first=0, count=1)
    window.after(0)
    out = preprocess_cuda.preprocess_fused(means, camera(), cov3d_precomp=torch.ones(n, 6))
    torch.autograd.grad(out[0].sum(), [means])
    preprocess_cuda.preprocess_fused(means.detach(), camera(), cov3d_precomp=torch.ones(n, 6))
    window.close()
    launches = json.loads((tmp_path / "spans.json").read_text())["launches"]
    assert launches["preprocess_fwd"] == 2 and launches["preprocess_bwd"] == 1
    assert launches["blend_fwd"] == 0 and launches["blend_bwd"] == 0


def test_smoothing_kernels_launches_levels_and_reverse_builds_reach_spans_json(tmp_path,
                                                                                monkeypatch):
    """Through the smoothing kernels (stood in by their plain versions, as the
    CPU has no CUDA), a traced multi-resolution forward and gradient keeps one
    span and one row count a level, and ``spans.json`` counts a launch a level
    each way and the reverse maps built at the call: none when they are given."""
    from test_torch_smooth import stand_in_kernels

    from seganygaussians_torch.ops import smooth_cuda

    assert tracing._kernels()["smooth_fwd"] is smooth_cuda.FORWARD
    assert tracing._kernels()["smooth_bwd"] is smooth_cuda.BACKWARD
    stand_in_kernels(monkeypatch)
    n = 64
    g = torch.Generator().manual_seed(0)
    maps = tuple(torch.randint(0, n, (n, k), generator=g) for k in (4, 4, 16))
    x = torch.randn(n, D, generator=g).requires_grad_(True)
    built = []
    for reverse in (None, tuple(smooth_cuda.reverse_map(m) for m in maps)):
        window = tracing.ProfileWindow(str(tmp_path), first=0, count=1)
        window.after(0)
        out = smooth_cuda.smooth_mean(x, maps, "multi_res", reverse=reverse, level=fgm._level)
        torch.autograd.grad(out.sum(), [x])
        window.close()
        s = json.loads((tmp_path / "spans.json").read_text())
        assert {k: v["count"] for k, v in s["spans"].items()} == {
            "smoothing.level0": 1, "smoothing.level1": 1, "smoothing.level2": 1}
        assert s["launches"]["smooth_fwd"] == 3 and s["launches"]["smooth_bwd"] == 3
        assert {k: v for k, v in s["counters"].items() if k.startswith("smoothing.rows.")} == {
            "smoothing.rows.level0": n * 4, "smoothing.rows.level1": n * 4,
            "smoothing.rows.level2": n * 16}
        built.append(s["counters"]["smoothing.reverse_builds"])
    assert built == [3, 0]


def test_multi_res_levels_are_recorded_with_the_kernel_on_the_card():
    """On the card, the kernel path keeps the level spans (timed on the device)
    and row counters, and a trainer-style call with its reverse maps builds none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU or interpret mode)")
    from seganygaussians_torch.ops import smooth_cuda

    dev = torch.device("cuda")
    n = 4096
    g = torch.Generator(device=dev).manual_seed(0)
    maps = tuple(torch.randint(0, n, (n, k), generator=g, device=dev) for k in (4, 4, 16))
    pf = torch.randn(n, 32, generator=g, device=dev).requires_grad_(True)
    state = fgm.FeatureState(geom=None, point_features=pf, smooth_map=maps[2], opt=None)
    reverse = tuple(smooth_cuda.reverse_map(m) for m in maps)
    f0, b0 = smooth_cuda.FORWARD.launches, smooth_cuda.BACKWARD.launches
    _, s = profiled(lambda: torch.autograd.grad(
        fgm.smooth_features(state, "multi_res", maps=maps, reverse=reverse).sum(), [pf]))
    assert smooth_cuda.FORWARD.launches - f0 == 3 and smooth_cuda.BACKWARD.launches - b0 == 3
    for i in range(3):
        level = s["spans"][f"smoothing.level{i}"]
        assert level["count"] == 1 and level["device_ms"] is not None
    assert s["counters"]["smoothing.rows.level2"] == n * 16
    assert s["counters"]["smoothing.rows"] == n * 24
    assert s["counters"]["smoothing.reverse_builds"] == 0
    assert s["launches"]["smooth_fwd"] == 3 and s["launches"]["smooth_bwd"] == 3
