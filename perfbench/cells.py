"""The general runners, one per kind of traffic mix.

Each runner builds the cell's inputs from the seed, warms up every shape it
will use, runs the measured window for ``--seconds``, and in a traced run a
profiled window after it; then it frees the program's state and holds what
the window produced to the plain reference (``perfbench/reference``).

* ``scene_train``: ``SceneTrainer.run`` from iteration ``start_iteration``.
* ``segment``: one user of ``SagaSession``: similarity frames and clicks,
  ``segment3d`` and ``roll_back``.
* ``feature_train``: ``ContrastiveTrainer.run`` on seeded masks, smoothed as
  the configuration's ``feature.smooth_type`` says (``traditional`` or
  ``multi_res``).

A kind that is not here is run by ``perfbench/runners/<kind>.py``
(``perfbench/harness.py``).
"""

from __future__ import annotations

import math
import time
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from perfbench import checks, readers, scene, trace
from perfbench.harness import Cell, Outcome, Refused
from perfbench.reference import render as rr
from perfbench.reference import train as rt
from perfbench.reference.arith import Arith
from perfbench.work import blend as work_blend
from perfbench.work import step as work_step
from perfbench.reference import features as rf
from seganygaussians_torch.models import feature_gaussians as fgm
from seganygaussians_torch.models import gaussians as gm
from seganygaussians_torch.ops.binning import suggest_capacity
from seganygaussians_torch.ops.camera import CameraParams
from seganygaussians_torch.ops.projection import preprocess
from seganygaussians_torch.ops.rasterize import RasterConfig
from seganygaussians_torch.models import optim
from seganygaussians_torch.train.contrastive_trainer import ContrastiveHyper, ContrastiveTrainer
from seganygaussians_torch.train.scene_trainer import SceneTrainer
from seganygaussians_torch.seg.scale_gate import ScaleGateParams
from seganygaussians_torch.viewer.interactive import SagaSession

LEAVES = rt.LEAVES


def port_camera(cam: dict) -> CameraParams:
    return CameraParams(world_view=cam["world_view"], full_proj=cam["full_proj"],
                        cam_center=cam["cam_center"], width=cam["width"], height=cam["height"],
                        tan_fovx=cam["tan_fovx"], tan_fovy=cam["tan_fovy"])


def program_seed(seed: int) -> int:
    """The seed the program's own generators get."""
    return int(seed) % (1 << 62)


def camera_sequence(seed: int, views: int, count: int) -> list[int]:
    """The views a trainer seeded ``seed`` visits: a fresh permutation per
    epoch, taken from its end (``SceneTrainer._next_camera``)."""
    rng, stack, out = np.random.default_rng(seed), [], []
    while len(out) < count:
        if not stack:
            stack = list(rng.permutation(views))
        out.append(int(stack.pop()))
    return out


def capacity(params: dict, cams: list, tile: int) -> int:
    """The instance budget a user would set: the program's own tile count of
    the busiest view, with the program's headroom."""
    with torch.no_grad():
        act = rr.activate(params)
        most = max(int(preprocess(params["xyz"], port_camera(c), scales=act["scales"],
                                  rotations=act["quats"], tile_size=tile,
                                  opacities=act["opacity"]).tiles_touched.sum()) for c in cams)
    return suggest_capacity(most)


def serving_state(params: dict) -> gm.GaussianState:
    n = params["xyz"].shape[0]
    alive = torch.ones(n, dtype=torch.bool, device=params["xyz"].device)
    return gm.GaussianState(params=gm.GaussianParams(**params), alive=alive,
                            seg_mask=alive.float())


def norms(tree) -> dict:
    return {k: float(torch.linalg.vector_norm(getattr(tree, k).double())) for k in LEAVES}


def peak_memory(cell: Cell) -> int:
    """The run's peak device memory, read before the reference runs."""
    cell.log("program done")
    return int(torch.cuda.max_memory_allocated(cell.device)) if cell.device.type == "cuda" else 0


def release(cell: Cell) -> None:
    """Hand the dropped program state's memory back before the reference."""
    if cell.device.type == "cuda":
        torch.cuda.synchronize(cell.device)
        torch.cuda.empty_cache()


def limit(cell: Cell, name: str) -> float:
    """A check's limit (``perfbench/limits/<cell>.json``); a check without
    one cannot pass."""
    return float(cell.limits.get(name, {}).get("limit", -1.0))


def frame_work(params: dict, cams: list, ar: Arith, channels: int = 3, colors=None,
               sh_degree: int = 3) -> list:
    """The reference's blend counts of each camera's frame."""
    out = []
    with torch.no_grad():
        act = rr.activate(params)
        for cam in cams:
            rc = rr.camera_on(cam, params["xyz"].device)
            frame, (bins, _, _) = rr.render(act, rc, ar, sh_degree, colors=colors)
            out.append(work_blend.count(bins, frame, rc.width, rc.height, channels))
    return out


def open_loop(count: int, rate: float, serve) -> tuple[list, list, float]:
    """``count`` requests, one due every 1/rate seconds from now, served in
    order by ``serve(i)``.  Each latency runs from its request's due time, so
    the wait that a slow request imposes on the ones behind it counts.
    Returns (latencies, how late each request was issued after its due time,
    both in seconds, and the window's length)."""
    t0 = time.perf_counter()
    latencies, late = [], []
    for i in range(count):
        due = t0 + i / rate
        ahead = due - time.perf_counter()
        if ahead > 0:
            time.sleep(ahead)
        late.append(time.perf_counter() - due)
        serve(i)
        latencies.append(time.perf_counter() - due)
    return latencies, late, time.perf_counter() - t0


def mean_work(items: list) -> tuple[float, float]:
    return (sum(w[0] for w in items) / len(items), sum(w[1] for w in items) / len(items))


# ---------------------------------------------------------------------------
# scene_train
# ---------------------------------------------------------------------------


def scene_train(cell: Cell) -> Outcome:
    cfg, mix, dev = cell.config, cell.mix, cell.device
    out = Outcome()
    params = scene.gaussians(cfg, cell.seed, dev)
    cams = scene.views(cfg, cell.seed)
    gts = scene.images(cfg, cell.seed, dev)
    extent = scene.spatial_extent(cams)
    cameras = [SimpleNamespace(params=port_camera(c), image=gts[i].cpu().numpy(),
                               image_name=f"view_{i}") for i, c in enumerate(cams)]
    config = RasterConfig(tile_size=cfg["tile_size"], capacity=capacity(params, cams,
                                                                         cfg["tile_size"]))
    state = gm.with_training_fields(serving_state(params))
    p0 = state.params
    del params, gts
    seed = program_seed(cell.seed)
    trainer = SceneTrainer(state, cameras, spatial_lr_scale=extent, sh_degree=cfg["sh_degree"],
                           config=config, seed=seed)
    del state
    for i, cam in enumerate(cameras):
        trainer._image(i, cam)  # the ground truth on the device once, as in a run
    for cam in cameras:
        cam.image = None

    # The checked steps: the window's own call on the window's trainer.
    losses, nonfinite = [], []

    def record(_trainer, _it, m):
        losses.append(m["loss"])
        nonfinite.append(m["nonfinite"])

    trainer.on_iteration = record
    it = int(mix["start_iteration"])
    trainer.run(iterations=it + 1, start_iteration=it)
    grad1 = {k: v / (1 - rt.BETAS[0]) for k, v in norms(trainer.state.opt.mu).items()}
    trainer.run(iterations=it + 3, start_iteration=it + 1)
    now = trainer.state.params
    change = {k: float(torch.linalg.vector_norm((getattr(now, k) - getattr(p0, k)).double()))
              for k in LEAVES}
    prog_losses = [float(x) for x in losses[:3]]
    del p0, now
    it += 3
    trainer.run(iterations=it + mix["warmup_steps"], start_iteration=it)
    it += mix["warmup_steps"]
    losses.clear()
    nonfinite.clear()

    cell.setup_done()
    chunk, steps = int(mix["steps_per_call"]), 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < cell.seconds:
        trainer.run(iterations=it + chunk, start_iteration=it)
        it, steps = it + chunk, steps + chunk
    cell.sync()
    window_s = time.perf_counter() - t0
    out.attempted = steps
    out.failed = int(sum(bool(x) for x in nonfinite))
    out.end_to_end["scene_step_ms"] = window_s / steps * 1e3

    traced_views = []
    if cell.trace:
        units = int(mix["trace_units"])
        traced_views = camera_sequence(seed, len(cams), it + units - int(mix["start_iteration"]))
        traced_views = traced_views[-units:]

        def run(n):
            trainer.run(iterations=it + n, start_iteration=it)

        tr = trace.profile(run, units, cell.root / "perfbench" / "layers.json")
    out.memory_peak_bytes = peak_memory(cell)
    del trainer, cameras
    release(cell)

    # The reference follows the first three steps from the same inputs.
    ar = Arith(tf32=False)
    order = camera_sequence(seed, len(cams), 3)
    ref = reference_scene_steps(cell, order, ar)
    out.checks = [
        ("loss_gap", checks.loss_gap(prog_losses, ref["losses"]), limit(cell, "loss_gap")),
        ("grad_gap", checks.worst_leaf_gap(grad1, ref["grad1"]), limit(cell, "grad_gap")),
        ("change_gap", checks.worst_leaf_gap(change, ref["change"],
                                             checks.moving_leaves(ref["grad1"])),
         limit(cell, "change_gap")),
    ]
    out.readings = {"losses": (prog_losses, ref["losses"]), "grad1": (grad1, ref["grad1"]),
                    "change": (change, ref["change"])}
    if cell.trace:
        params = scene.gaussians(cfg, cell.seed, dev)
        frames = frame_work(params, [cams[v] for v in traced_views], ar)
        n = cfg["num_gaussians"]
        work = {"blend_fwd": mean_work([work_blend.forward(f) for f in frames]),
                "blend_bwd": mean_work([work_blend.backward(f) for f in frames]),
                "step": mean_work([work_step.scene_train(n, f) for f in frames])}
        out.metric_context = readers.Context(tr, window_s / steps, work, [])
    return out


def reference_scene_steps(cell: Cell, order: list, ar: Arith, steps: int = 3) -> dict:
    """The reference's losses, first gradient norms and change norms over
    ``steps`` training steps from the cell's seed-made inputs."""
    cfg, dev = cell.config, cell.device
    params = scene.gaussians(cfg, cell.seed, dev)
    gts = scene.images(cfg, cell.seed, dev)
    cams = scene.views(cfg, cell.seed)
    extent = scene.spatial_extent(cams)
    start = int(cell.mix["start_iteration"])
    p0 = dict(params)
    moments = {k: (torch.zeros_like(v), torch.zeros_like(v)) for k, v in params.items()}
    losses, grad1 = [], None
    for i in range(steps):
        rc = rr.camera_on(cams[order[i]], dev)
        loss, grads, _ = rt.loss_and_grads(params, rc, gts[order[i]], ar, cfg["sh_degree"])
        if i == 0:
            grad1 = {k: float(torch.linalg.vector_norm(g.double())) for k, g in grads.items()}
        params, moments = rt.adam(params, grads, moments, i,
                                  rt.learning_rates(start + 1 + i, extent))
        losses.append(loss)
    change = {k: float(torch.linalg.vector_norm((params[k] - p0[k]).double())) for k in LEAVES}
    return {"losses": losses, "grad1": grad1, "change": change}


def orbit_requests(cfg: dict, mix: dict, seed: int):
    """The viewer's cameras, one a request, for as long as asked: a step of
    a few degrees along the orbit, turning back every ``turn_every``."""
    rng = np.random.default_rng([int(seed), 6])
    az = rng.uniform(0, 2 * math.pi)
    lo, hi = mix["step_degrees"]
    sign, i = 1.0, 0
    while True:
        if i and i % mix["turn_every"] == 0:
            sign = -sign
        az += sign * math.radians(rng.uniform(lo, hi))
        el = cfg["orbit"]["elevation"] + rng.uniform(-0.05, 0.05)
        yield scene.orbit_camera(cfg, az, el)
        i += 1


# ---------------------------------------------------------------------------
# The feature field: segment and feature_train
# ---------------------------------------------------------------------------


def seeded_features(cell: Cell):
    """The scene's Gaussians and the seed's features and gate."""
    params = scene.gaussians(cell.config, cell.seed, cell.device)
    feats, gate = scene.features(cell.config, params["xyz"], cell.seed)
    return params, feats, gate


def feature_inputs(cell: Cell):
    """:func:`seeded_features`, the frozen geometry the program's
    FeatureState holds, and the program's own neighbour map (set-up work)."""
    params, feats, gate = seeded_features(cell)
    alive = torch.ones(params["xyz"].shape[0], dtype=torch.bool, device=cell.device)
    geom = fgm.FrozenGeometry(xyz=params["xyz"], scaling=params["scaling"],
                              rotation=params["rotation"], opacity=params["opacity"], alive=alive)
    smooth_map = fgm.build_smooth_map(params["xyz"], int(cell.config["feature"]["smooth_k"]))
    return params, feats, gate, geom, smooth_map


def reference_geometry(params: dict) -> dict:
    return rr.activate({k: params[k] for k in ("xyz", "scaling", "rotation", "opacity")})


def click_pixel(rng, cfg) -> tuple[int, int]:
    """A click inside the frame's central half, where the object is."""
    return (int(rng.uniform(0.3, 0.7) * cfg["width"]), int(rng.uniform(0.3, 0.7) * cfg["height"]))


def segment_kinds(mix: dict) -> list[str]:
    """The kinds of one cycle's requests, in order; the state after a cycle
    is its start."""
    clicks = ["similarity"] * mix["views_per_click"] + ["click"]
    return clicks * mix["clicks_per_segment"] + ["segment", "restart"]


def segment_sample(mix: dict, count: int, rng) -> set[int]:
    """The window's requests whose answers are compared, drawn from all
    ``count`` of them: ``sample`` similarity frames, the last similarity
    frame (after every roll_back of the window) and the first and last
    ``segment3d``."""
    kinds = segment_kinds(mix)
    kind = [kinds[i % len(kinds)] for i in range(count)]
    sims = [i for i in range(count) if kind[i] == "similarity"]
    segs = [i for i in range(count) if kind[i] == "segment"]
    keep = {int(i) for i in rng.choice(sims, min(mix["sample"], len(sims)), replace=False)}
    return keep | set(sims[-1:]) | set(segs[:1]) | set(segs[-1:])


def segment(cell: Cell) -> Outcome:
    cfg, mix, dev = cell.config, cell.mix, cell.device
    if cfg["feature"]["smooth_type"] != "traditional":
        raise Refused(f"segment runs SagaSession, which smooths over the K-neighbour map only; "
                      f"smooth_type is {cfg['feature']['smooth_type']!r}")
    out = Outcome()
    params, feats, gate, geom, smooth_map = feature_inputs(cell)
    fs = fgm.FeatureState(geom=geom, point_features=feats, smooth_map=smooth_map, opt=None)
    config = RasterConfig(tile_size=cfg["tile_size"],
                          capacity=capacity(params, scene.views(cfg, cell.seed), cfg["tile_size"]))
    session = SagaSession(serving_state(params), fs, ScaleGateParams(gate["w"], gate["b"]),
                          None, config=config, seed=program_seed(cell.seed))
    session.scale = float(mix["scale"])
    session_threshold = session.threshold
    del params, feats, gate, geom
    rng = np.random.default_rng([int(cell.seed), 9])
    views = orbit_requests(cfg, mix, cell.seed)

    # Requests: (kind, camera, pixel), a cycle of segment_kinds at a time.
    def cycle():
        return [(kind, None if kind == "segment" else next(views),
                 click_pixel(rng, cfg) if kind in ("click", "restart") else None)
                for kind in segment_kinds(mix)]

    first = (next(views), click_pixel(rng, cfg))
    session.click(*first[1], cam=port_camera(first[0]))
    prompts_in_effect = [first]  # (camera, pixel) of every prompt, by request

    def serve(kind, cam, px):
        if kind == "similarity":
            return session.render_similarity(port_camera(cam))
        if kind == "click":
            session.click(*px, cam=port_camera(cam))
        elif kind == "segment":
            mask = session.segment3d().cpu().numpy()
            session.roll_back()
            return mask
        else:  # restart: the user clears the prompts and clicks a new object
            session.clear_clicks()
            session.click(*px, cam=port_camera(cam))
        cell.sync()
        return None

    warm = cycle()
    for kind in ("similarity", "click", "segment", "restart"):
        k, cam, px = next(r for r in warm if r[0] == kind)
        serve(k, cam, px)
    session.clear_clicks()
    session.click(*first[1], cam=port_camera(first[0]))

    count = int(float(mix["rate_per_s"]) * cell.seconds)
    keep = segment_sample(mix, count, rng)
    cell.setup_done()
    kept, failed, queue = {}, [], []

    def serve_next(i):
        nonlocal queue, prompts_in_effect
        if not queue:
            queue = cycle()
        kind, cam, px = queue.pop(0)
        try:
            answer = serve(kind, cam, px)
        except RuntimeError:
            failed.append(i)
            answer = None
        if kind == "restart":
            prompts_in_effect = []
        if kind in ("click", "restart"):
            prompts_in_effect = prompts_in_effect + [(cam, px)]
        if i in keep:
            kept[i] = (kind, cam, list(prompts_in_effect), answer)

    latencies, late, window_s = open_loop(count, float(mix["rate_per_s"]), serve_next)
    out.attempted, out.failed = len(latencies), len(failed)
    out.end_to_end["request_ms_p95"] = float(np.percentile(latencies, 95)) * 1e3
    cell.log(f"generator late: mean {np.mean(late) * 1e3:.3f} ms, p95 "
             f"{np.percentile(late, 95) * 1e3:.3f} ms, max {np.max(late) * 1e3:.3f} ms")
    traced = []
    if cell.trace:
        def run(n):
            for _ in range(n):
                nonlocal queue
                if not queue:
                    queue = cycle()
                kind, cam, px = queue.pop(0)
                traced.append((kind, cam))
                serve(kind, cam, px)

        tr = trace.profile(run, int(mix["trace_units"]), cell.root / "perfbench" / "layers.json")
    out.memory_peak_bytes = peak_memory(cell)
    del session, fs
    release(cell)

    # The reference: smoothing over the program's neighbour map (set-up
    # state, held to an exact kNN by map_checks), gate, C = 32 render,
    # prompts from its own renders of the clicks.
    ar = Arith(tf32=False)
    params, feats, gate = seeded_features(cell)
    geom = reference_geometry(params)
    # Nothing compared of a kind cannot pass.
    kinds = {v[0] for v in kept.values()}
    sim_off = 0.0 if "similarity" in kinds else math.inf
    mask_off = 0.0 if "segment" in kinds else math.inf
    with torch.no_grad():
        smoothed = rf.smooth(feats, smooth_map)
        colors = rf.gated(smoothed, gate["w"], gate["b"], float(mix["scale"]))
        cache = {}

        def prompt(cam, px):
            key = (id(cam), px)
            if key not in cache:
                prepared = rr.prepare(geom, rr.camera_on(cam, dev), ar, colors=colors)
                cache[key] = rf.normalize(rr.pixel(prepared, *px))
            return cache[key]

        for i, (kind, cam, effect, answer) in sorted(kept.items()):
            if answer is None:
                sim_off = mask_off = math.inf
                continue
            prompts = torch.stack([prompt(c, p) for c, p in effect])
            if kind == "similarity":
                frame, _ = rf.feature_map(geom, colors, rr.camera_on(cam, dev), ar)
                want = rf.similarity(frame.image, prompts, ar).cpu().numpy()
                sim_off = max(sim_off, checks.values_off_share(answer, want, mix["score_tol"]))
            else:
                score = rf.segment_scores(smoothed, gate["w"], gate["b"], float(mix["scale"]),
                                          prompts, ar).cpu().numpy()
                mask_off = max(mask_off, checks.mask_off_share(answer, score,
                                                               session_threshold, mix["mask_tol"]))
        out.checks = [("similarity_off", sim_off, limit(cell, "similarity_off")),
                      ("mask_off", mask_off, limit(cell, "mask_off"))]
        out.checks += map_checks(cell, params["xyz"], smoothing_of(cell, smooth_map))
    if cell.trace:
        n, d = cfg["num_gaussians"], int(cfg["feature"]["dim"])
        k = int(cfg["feature"]["smooth_k"])
        rendered = [(kind, cam) for kind, cam in traced if cam is not None]
        stride = max(1, len(rendered) // mix["work_sample"])
        sample = rendered[::stride][: mix["work_sample"]]
        frames = frame_work(params, [c for _, c in sample], ar, channels=d, colors=colors)
        fwd = [work_blend.forward(f) for f in frames]
        render = mean_work([work_step.feature_request(n, k, d, f, False) for f in frames])
        per_kind = {"similarity": mean_work([work_step.feature_request(n, k, d, f, True)
                                             for f in frames]),
                    "click": render, "restart": render, "segment": work_step.segment3d(n, k, d)}
        step = mean_work([per_kind[kind] for kind, _ in traced])
        renders = sum(kind != "segment" for kind, _ in traced) / len(traced)
        out.metric_context = readers.Context(
            tr, float(np.mean(latencies)),
            {"blend_fwd": tuple(x * renders for x in mean_work(fwd)), "step": step},
            [x * 1e3 for x in latencies], [x * 1e3 for x in late])
    return out


class Level(NamedTuple):
    """One neighbour map that the smoothing averages over, as the program
    holds it.  ``self_first``: column 0 is the point itself and the rest its
    nearest other points (the K-neighbour map); else the map lists each
    point's nearest points of a subsample, the point itself among them where
    it is one (a multi-resolution level).  ``step_cols``: the columns a
    training step averages over."""
    map: torch.Tensor
    self_first: bool
    step_cols: int

    def neighbours(self) -> tuple:
        """(neighbour columns (N, k), the points they are drawn from as
        indices or None for all, whether a point is its own neighbour).  A
        level's subsample is the set of indices its map holds: a subsampled
        point is queried from its own position and finds itself at distance
        0, so the set is exact, and :func:`map_faults` holds that."""
        if self.self_first:
            return self.map[:, 1:], None, False
        return self.map, level_source(self.map), True


class Smoothing(NamedTuple):
    """What the feature field smooths over: ``kind`` the configuration's
    ``feature.smooth_type``, its levels, and ``sums`` the additions of N·d
    that put the levels together."""
    kind: str
    levels: tuple
    sums: int

    @property
    def maps(self) -> tuple:
        return tuple(level.map for level in self.levels)


def smoothing_of(cell: Cell, smooth_map, trainer=None) -> Smoothing:
    """The configuration's smoothing over the program's maps: the
    K-neighbour map ``smooth_map`` (``traditional``), or the levels the
    ``trainer`` built (``multi_res``, :func:`level_maps`)."""
    f = cell.config["feature"]
    if f["smooth_type"] == "traditional":
        k = int(f["smooth_k"] * f["smooth_dropout"])
        return Smoothing("traditional", (Level(smooth_map, True, k),), 0)
    if f["smooth_type"] == "multi_res" and trainer is not None:
        maps = level_maps(cell, trainer)
        return Smoothing("multi_res", tuple(Level(m, False, m.shape[1]) for m in maps), len(maps))
    raise Refused(f"{cell.mix['kind']} has no reference for smooth_type {f['smooth_type']!r}")


def map_checks(cell: Cell, xyz, smoothing: Smoothing) -> list:
    """The program's neighbour maps against an exact kNN of the seed's points
    (``reference/features.nearest``) on a seeded sample of ``map_rows`` rows:
    ``map_faults`` (:func:`map_faults`), and ``knn_miss`` the worst level's
    share of neighbours that are not among the exact nearest
    (:meth:`Level.neighbours`)."""
    g = scene.generator(cell.seed, 11, cell.device)
    rows = torch.randperm(xyz.shape[0], generator=g, device=cell.device)[: cell.mix["map_rows"]]
    miss = 0.0
    for level in smoothing.levels:
        cols, source, itself = level.neighbours()
        _, d2 = rf.nearest(xyz, rows, cols.shape[1], Arith(tf32=False), source=source)
        given = cols[rows].clamp(0, xyz.shape[0] - 1)  # an index out of range is a map fault
        miss = max(miss, rf.neighbour_misses(xyz, rows, given, d2[:, -1], itself))
    return [("map_faults", map_faults(smoothing), limit(cell, "map_faults")),
            ("knn_miss", miss, limit(cell, "knn_miss"))]


def level_source(level_map) -> torch.Tensor:
    """The indices in range that a level's map holds: its subsample."""
    n = level_map.shape[0]
    member = torch.zeros(n, dtype=torch.bool, device=level_map.device)
    member[level_map[(level_map >= 0) & (level_map < n)]] = True
    return torch.nonzero(member).flatten()


def map_faults(smoothing: Smoothing) -> float:
    """Share of points whose row of some level's map is not a neighbour list
    of their own: an index out of range, or the point not where its level
    puts it (column 0 of the K-neighbour map; anywhere in its row of a
    level whose subsample holds it)."""
    bad = None
    for level in smoothing.levels:
        m = level.map
        n = m.shape[0]
        rows = torch.arange(n, device=m.device)
        if level.self_first:
            own = m[:, 0] != rows
        else:
            member = torch.zeros(n, dtype=torch.bool, device=m.device)
            member[level_source(m)] = True
            own = member & ~(m == rows[:, None]).any(1)
        row_bad = own | (m < 0).any(1) | (m >= n).any(1)
        bad = row_bad if bad is None else bad | row_bad
    return float(bad.float().mean())


def level_maps(cell: Cell, trainer) -> tuple:
    """The trainer's multi-resolution maps, refused unless they are the
    levels the configuration states (``feature.multi_res``): the same widths,
    and subsamples within six standard deviations of the stated rates."""
    stated = cell.config["feature"].get("multi_res")
    if stated is None:
        raise Refused("smooth_type multi_res, but the configuration states no feature.multi_res")
    maps = trainer.consts.multi_res_maps
    ks = [m.shape[1] for m in maps]
    if ks != [int(k) for k in stated["ks"]] or len(stated["sample_rates"]) != len(ks):
        raise Refused(f"the trainer built levels of widths {ks}; the configuration states "
                      f"{stated}")
    for m, rate in zip(maps, stated["sample_rates"]):
        n, p = m.shape[0], min(float(rate), 1.0)
        share = level_source(m).numel() / n
        if abs(share - p) > 6 * math.sqrt(p * (1 - p) / n) + 1 / n:
            raise Refused(f"a level's subsample holds {share:.4f} of the points; the "
                          f"configuration states the rate {rate}")
    return maps


def feature_trainer(cell: Cell) -> SimpleNamespace:
    """The ``ContrastiveTrainer`` a ``feature_train`` run times, built from
    the seed, with its start (``start``: the features and the gate),
    its smoothing (:func:`smoothing_of`), its cameras and their seed-made
    views (``cams``)."""
    cfg, dev = cell.config, cell.device
    f = cfg["feature"]
    params, _, gate, geom, smooth_map = feature_inputs(cell)
    cams = scene.views(cfg, cell.seed)
    config = RasterConfig(tile_size=cfg["tile_size"],
                          capacity=capacity(params, cams, cfg["tile_size"]))
    cameras = []
    for v, cam in enumerate(cams):
        m, s = scene.masks(cfg, cell.seed, v, dev)
        cameras.append(SimpleNamespace(params=port_camera(cam), sam_masks=m.cpu().numpy(),
                                       mask_scales=s))
    pf0 = initial_features(cell, params["xyz"].shape[0])
    w0, b0 = gate["w"], gate["b"]
    fs = fgm.FeatureState(geom=geom, point_features=pf0, smooth_map=smooth_map,
                          opt=optim.adam_init(fgm.FeatureParams(pf0)))
    hyper = ContrastiveHyper(num_sampled_rays=int(f["num_sampled_rays"]),
                             smooth_k=int(f["smooth_k"]), smooth_dropout=float(f["smooth_dropout"]),
                             smooth_type=f["smooth_type"])
    trainer = ContrastiveTrainer(fs, ScaleGateParams(w0, b0), cameras, hyper=hyper,
                                 config=config, seed=program_seed(cell.seed))
    # What the trainer smooths over, set-up state that map_checks holds to an
    # exact kNN.  Under multi_res the K-neighbour map is built all the same,
    # as the contrastive CLI's feature model builds it.
    return SimpleNamespace(trainer=trainer, cameras=cameras, cams=cams,
                           start={"features": pf0, "w": w0, "b": b0},
                           smoothing=smoothing_of(cell, smooth_map, trainer))


def initial_features(cell: Cell, n: int) -> torch.Tensor:
    """Features as a new feature field starts them: randn · 1e-2."""
    g = scene.generator(cell.seed, 7, cell.device)
    d = int(cell.config["feature"]["dim"])
    return 1e-2 * torch.randn(n, d, generator=g, device=cell.device)


def feature_train(cell: Cell) -> Outcome:
    cfg, mix, dev = cell.config, cell.mix, cell.device
    f = cfg["feature"]
    out = Outcome()
    built = feature_trainer(cell)
    trainer, cameras, cams, sm = built.trainer, built.cameras, built.cams, built.smoothing
    pf0, w0, b0 = built.start["features"], built.start["w"], built.start["b"]
    seed = program_seed(cell.seed)
    del built
    for i, cam in enumerate(cameras):
        trainer._prep(i)  # the mask stacks on the device once, as in a run
        cam.sam_masks = None

    # The checked steps, through the window's own call: one step, then two.
    trainer.run(iterations=1, log_every=1)
    b1 = 1 - rt.BETAS[0]
    grad1 = {"features": trainer.feat_state.opt.mu.point_features, "w": trainer.gate_opt.mu.w,
             "b": trainer.gate_opt.mu.b}
    grad1 = {k: float(torch.linalg.vector_norm(v.double())) / b1 for k, v in grad1.items()}

    def change_from_start():
        now = {"features": trainer.feat_state.point_features, "w": trainer.gate_params.w,
               "b": trainer.gate_params.b}
        return {k: float(torch.linalg.vector_norm((now[k] - v).double()))
                for k, v in (("features", pf0), ("w", w0), ("b", b0))}

    change1 = change_from_start()
    trainer.run(iterations=2, log_every=1)
    prog_losses = [m["loss"] for m in trainer.metrics_history[:3]]
    change = change_from_start()
    del pf0
    cell.sync()
    t = time.perf_counter()
    trainer.run(iterations=int(mix["warmup_steps"]))
    cell.sync()
    per_step = (time.perf_counter() - t) / int(mix["warmup_steps"])

    cell.setup_done()
    steps = max(1, round(cell.seconds / per_step))
    t0 = time.perf_counter()
    trainer.run(iterations=steps)
    cell.sync()
    window_s = time.perf_counter() - t0
    out.attempted = steps
    out.end_to_end["feature_step_ms"] = window_s / steps * 1e3
    if cell.trace:
        units = int(mix["trace_units"])
        tr = trace.profile(lambda n: trainer.run(iterations=n), units,
                           cell.root / "perfbench" / "layers.json")
        traced_views = camera_sequence(seed, len(cams), units)
    out.memory_peak_bytes = peak_memory(cell)
    del trainer, cameras
    release(cell)

    ar = Arith(tf32=False)
    order = camera_sequence(seed, len(cams), 1) + camera_sequence(seed, len(cams), 2)
    ref = reference_feature_steps(cell, sm, order, ar)
    # The first step's loss, every leaf's first gradient and the change of
    # the moving leaves after the first step.  Adam's first step moves a few
    # hundred feature coordinates whose gradient is rounding by a full lr on
    # one side only, so steps 2-3 and the change after them carry that noise
    # (PERF.md).
    out.checks = [
        ("loss1_gap", checks.loss_gap(prog_losses[:1], ref["losses"][:1]),
         limit(cell, "loss1_gap")),
        ("grad_gap", checks.worst_leaf_gap(grad1, ref["grad1"]), limit(cell, "grad_gap")),
        ("change_gap", checks.worst_leaf_gap(change1, ref["change1"],
                                             checks.moving_leaves(ref["grad1"])),
         limit(cell, "change_gap")),
    ]
    out.checks += map_checks(cell, scene.gaussians(cfg, cell.seed, dev)["xyz"], sm)
    out.readings = {"losses": (prog_losses, ref["losses"]), "grad1": (grad1, ref["grad1"]),
                    "change1": (change1, ref["change1"]), "change": (change, ref["change"])}
    if cell.trace:
        params = scene.gaussians(cfg, cell.seed, dev)
        d = int(f["dim"])
        colors = rf.safe_normalize(rf.smoothing(
            sm.kind, initial_features(cell, params["xyz"].shape[0]), sm.maps))
        frames = frame_work(params, [cams[v] for v in traced_views[: mix["work_sample"]]], ar,
                            channels=d, colors=colors)
        n = cfg["num_gaussians"]
        work = {"blend_fwd": mean_work([work_blend.forward(x) for x in frames]),
                "blend_bwd": mean_work([work_blend.backward(x) for x in frames]),
                "step": mean_work([work_step.feature_train(n, [lv.step_cols for lv in sm.levels],
                                                           sm.sums, d,
                                                           int(f["num_sampled_rays"]),
                                                           rf.NUM_SAMPLED_SCALES + 2, x)
                                   for x in frames])}
        out.metric_context = readers.Context(tr, window_s / steps, work, [])
    return out


def reference_feature_steps(cell: Cell, sm: Smoothing, order: list, ar: Arith) -> dict:
    """The reference's three contrastive steps from the seed's inputs,
    smoothed as ``sm`` over the program's neighbour maps, with the trainer's
    draws."""
    cfg, dev = cell.config, cell.device
    f = cfg["feature"]
    params, _, gate = seeded_features(cell)
    geom = reference_geometry(params)
    cams = scene.views(cfg, cell.seed)
    stacks = [scene.masks(cfg, cell.seed, v, dev) for v in range(len(cams))]
    all_scales = torch.tensor(np.concatenate([s for _, s in stacks]), device=dev)
    quantiles, upper = rf.fit_quantiles(all_scales), all_scales.max()
    g = torch.Generator(device=dev).manual_seed(program_seed(cell.seed))
    leaves = {"features": initial_features(cell, params["xyz"].shape[0]), "w": gate["w"],
              "b": gate["b"]}
    p0 = dict(leaves)
    moments = {k: (torch.zeros_like(v), torch.zeros_like(v)) for k, v in leaves.items()}
    lrs = dict.fromkeys(leaves, 0.0025)
    losses, grad1 = [], None
    for i, v in enumerate(order):
        m = rf.sorted_masks(*(torch.as_tensor(x, device=dev) for x in stacks[v]))
        d = rf.draw(g, m, int(f["num_sampled_rays"]), int(f["smooth_k"]), float(f["smooth_dropout"]),
                    sm.kind)
        loss, gf, gw, gb = rf.contrastive_grads(leaves["features"], leaves["w"], leaves["b"],
                                                sm.kind, sm.maps, geom,
                                                rr.camera_on(cams[v], dev), m, d, upper, quantiles,
                                                ar)
        grads = {"features": gf, "w": gw, "b": gb}
        if i == 0:
            grad1 = {k: float(torch.linalg.vector_norm(x.double())) for k, x in grads.items()}
        leaves, moments = rt.adam(leaves, grads, moments, i, lrs)
        losses.append(loss)
        if i == 0:
            change1 = {k: float(torch.linalg.vector_norm((leaves[k] - p0[k]).double())) for k in p0}
    change = {k: float(torch.linalg.vector_norm((leaves[k] - p0[k]).double())) for k in p0}
    return {"losses": losses, "grad1": grad1, "change1": change1, "change": change}


KINDS = {"scene_train": scene_train, "segment": segment, "feature_train": feature_train}
