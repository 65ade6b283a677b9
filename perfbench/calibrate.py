#!/usr/bin/env python3
"""Readings for the limits of ``correct``: the program's over many seeds and
the control's, in one process.  Not run by the benchmark's runs.

    python3 perfbench/calibrate.py --workload m360_garden.scene_train \\
        --seeds 101-112 --control-seeds 101-103 --seconds 2
    python3 perfbench/calibrate.py --workload m360_garden.segment --map-seeds 101-112

For each seed the cell's runner runs as in a benchmark run with a short
window and prints its readings (the numbers compared, before any limit).
The control is the reference one precision step below the configuration's
(float32 with TF32 off → TF32: ``reference/arith.py``) put in the
program's place: its outputs are compared with the IEEE reference's by the
same numbers.  The feature cells' neighbour readings, the control and the
fault follow the configuration's ``feature.smooth_type``.  A kind with a
runner of its own (``perfbench/runners/<kind>.py``) gives its control by
that file's ``control(cell)``.  One JSON line per reading.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import cells, checks, harness, scene  # noqa: E402
from perfbench.reference import features as rf  # noqa: E402
from perfbench.reference import render as rr  # noqa: E402
from perfbench.reference.arith import Arith  # noqa: E402


def seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def control_scene_train(cell) -> dict:
    order = cells.camera_sequence(cells.program_seed(cell.seed), int(cell.config["views"]), 3)
    ref = cells.reference_scene_steps(cell, order, Arith(False))
    ctl = cells.reference_scene_steps(cell, order, Arith(True))
    return {"loss1_gap": checks.loss_gap(ctl["losses"][:1], ref["losses"][:1]),
            "loss_gap_3steps": checks.loss_gap(ctl["losses"], ref["losses"]),
            "grad_gap": checks.worst_leaf_gap(ctl["grad1"], ref["grad1"]),
            "change_gap": checks.worst_leaf_gap(ctl["change"], ref["change"],
                                                checks.moving_leaves(ref["grad1"]))}


def program_smoothing(cell) -> cells.Smoothing:
    """What the program smooths over in the cell's runner: the maps of the
    trainer that ``feature_train`` builds, or the K-neighbour map that
    ``segment``'s session gets."""
    if cell.mix["kind"] == "feature_train":
        return cells.feature_trainer(cell).smoothing
    return cells.smoothing_of(cell, cells.feature_inputs(cell)[-1])


def control_map(cell, xyz, sm: cells.Smoothing) -> float:
    """The exact kNN put in the program's place, computed in TF32: its
    neighbours' miss share against the IEEE one on the runs' sample of rows,
    the worst of the smoothing's levels."""
    g = scene.generator(cell.seed, 11, cell.device)
    rows = torch.randperm(xyz.shape[0], generator=g, device=cell.device)[: cell.mix["map_rows"]]
    miss = 0.0
    for level in sm.levels:
        cols, source, itself = level.neighbours()
        k = cols.shape[1]
        _, d2 = rf.nearest(xyz, rows, k, Arith(False), source=source)
        ctl, _ = rf.nearest(xyz, rows, k, Arith(True), source=source)
        miss = max(miss, rf.neighbour_misses(xyz, rows, ctl, d2[:, -1], itself))
    return miss


def altered_map(smooth_map):
    """The fault "an answer altered where it is produced": one neighbour
    column of every row taken from the next row's list."""
    bad = smooth_map.clone()
    c = smooth_map.shape[1] // 2
    bad[:, c] = torch.roll(smooth_map[:, c], 1)
    return bad


def altered(sm: cells.Smoothing) -> cells.Smoothing:
    """:func:`altered_map` of every level's map."""
    return sm._replace(levels=tuple(lv._replace(map=altered_map(lv.map)) for lv in sm.levels))


def map_readings(cell) -> dict:
    """The neighbour maps' readings without a run: the program's, the
    control's, and the altered maps'."""
    sm = program_smoothing(cell)
    xyz = scene.gaussians(cell.config, cell.seed, cell.device)["xyz"]
    program = dict((n, v) for n, v, _ in cells.map_checks(cell, xyz, sm))
    fault = dict((n, v) for n, v, _ in cells.map_checks(cell, xyz, altered(sm)))
    return {"program": program, "control": {"knn_miss": control_map(cell, xyz, sm)},
            "fault": fault}


def control_feature_train(cell) -> dict:
    sm = program_smoothing(cell)
    xyz = scene.gaussians(cell.config, cell.seed, cell.device)["xyz"]
    knn = control_map(cell, xyz, sm)
    del xyz
    seed = cells.program_seed(cell.seed)
    v = int(cell.config["views"])
    order = cells.camera_sequence(seed, v, 1) + cells.camera_sequence(seed, v, 2)
    ref = cells.reference_feature_steps(cell, sm, order, Arith(False))
    ctl = cells.reference_feature_steps(cell, sm, order, Arith(True))
    return {"loss1_gap": checks.loss_gap(ctl["losses"][:1], ref["losses"][:1]),
            "loss_gap_3steps": checks.loss_gap(ctl["losses"], ref["losses"]),
            "grad_gap": checks.worst_leaf_gap(ctl["grad1"], ref["grad1"]),
            "change_gap": checks.worst_leaf_gap(ctl["change1"], ref["change1"],
                                                checks.moving_leaves(ref["grad1"])),
            "change_gap_3steps": checks.worst_leaf_gap(ctl["change"], ref["change"],
                                                       checks.moving_leaves(ref["grad1"])),
            "moving_leaves": checks.moving_leaves(ref["grad1"]), "grad1": ref["grad1"],
            "map_faults": 0.0, "knn_miss": knn}


def control_segment(cell, frames: int = 3) -> dict:
    cfg, mix, dev = cell.config, cell.mix, cell.device
    params, feats, gate, _, smooth_map = cells.feature_inputs(cell)
    geom = cells.reference_geometry(params)
    rng = np.random.default_rng([int(cell.seed), 9])
    gen = cells.orbit_requests(cfg, mix, cell.seed)
    clicks = [(next(gen), cells.click_pixel(rng, cfg)) for _ in range(3)]
    views = [next(gen) for _ in range(frames)]
    out = {}
    with torch.no_grad():
        smoothed = rf.smooth(feats, smooth_map)
        colors = rf.gated(smoothed, gate["w"], gate["b"], float(mix["scale"]))
        res = {}
        for tf32 in (False, True):
            ar = Arith(tf32)
            prompts = []
            for cam, px in clicks:
                prepared = rr.prepare(geom, rr.camera_on(cam, dev), ar, colors=colors)
                prompts.append(rf.normalize(rr.pixel(prepared, *px)))
            prompts = torch.stack(prompts)
            sims = [rf.similarity(rf.feature_map(geom, colors, rr.camera_on(c, dev), ar)[0].image,
                                  prompts, ar).cpu().numpy() for c in views]
            score = rf.segment_scores(smoothed, gate["w"], gate["b"], float(mix["scale"]),
                                      prompts, ar).cpu().numpy()
            res[tf32] = (sims, score)
        out["similarity_off"] = max(checks.values_off_share(a, b, mix["score_tol"])
                                    for a, b in zip(res[True][0], res[False][0]))
        out["mask_off"] = checks.mask_off_share(res[True][1] > 0.75, res[False][1], 0.75,
                                                mix["mask_tol"])
        out["map_faults"] = 0.0
        out["knn_miss"] = control_map(cell, params["xyz"], cells.smoothing_of(cell, smooth_map))
    return out


CONTROLS = {"scene_train": control_scene_train, "feature_train": control_feature_train,
            "segment": control_segment}


def control_of(root: Path, kind: str):
    if kind in CONTROLS:
        return CONTROLS[kind]
    return harness.load_file_module(root / "perfbench" / "runners" / f"{kind}.py").control


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--rates", default="", help="a serving cell's sweep: offered rates, comma-separated")
    p.add_argument("--map-seeds", default="", help="the neighbour map's readings alone, program and control")
    args = p.parse_args()
    root = ROOT
    bench = json.loads(open(os.path.join(root, "BENCHMARK.json")).read())
    workload = harness.find_workload(bench, args.workload)
    device = torch.device("cuda", 0)
    for seed in seeds(args.seeds) if args.seeds else []:
        a = argparse.Namespace(seed=seed, seconds=args.seconds, trace=0)
        cell = harness.Cell(Path(root), bench, workload, a, device,
                            time.perf_counter())
        t = time.perf_counter()
        out = harness.runner_of(Path(root), cell.mix["kind"], cells.KINDS)(cell)
        print(json.dumps({"reading": "program", "seed": seed,
                          "checks": {n: v for n, v, _ in out.checks},
                          "readings": out.readings,
                          "setup_s": cell.setup_s, "end_to_end": out.end_to_end,
                          "seconds": time.perf_counter() - t}), flush=True)
        del out
        torch.cuda.empty_cache()
    for seed in seeds(args.map_seeds) if args.map_seeds else []:
        a = argparse.Namespace(seed=seed, seconds=args.seconds, trace=0)
        cell = harness.Cell(Path(root), bench, workload, a, device, time.perf_counter())
        t = time.perf_counter()
        res = map_readings(cell)
        print(json.dumps({"reading": "map", "seed": seed, **res,
                          "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    for rate in [float(r) for r in args.rates.split(",") if r]:
        a = argparse.Namespace(seed=seeds(args.seeds)[0] if args.seeds else 1,
                               seconds=args.seconds, trace=0)
        cell = harness.Cell(Path(root), bench, workload, a, device,
                            time.perf_counter())
        cell.mix["rate_per_s"] = rate
        out = harness.runner_of(Path(root), cell.mix["kind"], cells.KINDS)(cell)
        print(json.dumps({"reading": "sweep", "rate_per_s": rate, "end_to_end": out.end_to_end,
                          "attempted": out.attempted}), flush=True)
        torch.cuda.empty_cache()
    for seed in seeds(args.control_seeds) if args.control_seeds else []:
        a = argparse.Namespace(seed=seed, seconds=args.seconds, trace=0)
        cell = harness.Cell(Path(root), bench, workload, a, device,
                            time.perf_counter())
        t = time.perf_counter()
        res = control_of(Path(root), cell.mix["kind"])(cell)
        print(json.dumps({"reading": "control", "seed": seed, "checks": res,
                          "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
