#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's render and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the forward- and backward-blend kernels from
``seganygaussians_torch/csrc`` (one ``nvcc`` each, started together) and runs
six phases, each of which raises on failure:

1. Kernel against its plain version (``ops/blend.py``) on the same CUDA
   inputs: ~2000 Gaussians at 256×192, C ∈ {3, 4, 32}.  Tolerances are those
   the Pallas kernel is held to: color 1e-4, final_t 5e-5, n_contrib exact.
2. Full size: a seeded synthetic scene at the size of a trained Mip-NeRF 360
   scene (3,000,000 Gaussians, SH degree 3, 1297×840 views).  RGB through
   ``render.render`` over 8 orbit cameras and 32-dim features through
   ``render.render_features``; the kernel is held against the plain version
   on 64 seeded tiles of each, times are taken with CUDA events, and the
   kernel's launch count over the renders must be > 0.
3. The port's ``cli/render.py`` on ``examples/synth_scene`` with a seeded
   20,000-Gaussian PLY: one non-constant PNG per camera.
4. The backward kernel against its plain version
   (``blend_cuda.blend_backward_plain``, autograd through ``ops/blend.py``):
   phase 1's whole frames at C ∈ {3, 4, 32}, then 64 seeded tiles of phase
   2's full-size frames at C = 3 and C = 32, with seeded ``g_tiles`` and a
   nonzero ``g_final_t``.  ``d_table`` and ``d_bg`` within 2e-4 of each
   column's largest absolute value (the JAX package's Pallas-vs-XLA gradient
   bound).  Kernel time at the full frame, bound, plain time on the subset.
5. ``train_step`` at full width: phase 2's 3M-Gaussian SH-degree-3 scene with
   the training fields (scale init through ``mean_sq_dist_to_3nn`` timed on
   its 3M points), targets rendered from a seeded perturbed copy at
   1297×840.  The loss on a fixed view must drop, parameters and Adam moments
   stay finite, the backward kernel's launches equal the steps and the
   forward's are ≥ them; one C = 32 feature gradient through
   ``render.render_features``; one ``densify_and_prune``; ms/step, a stage
   split and peak memory.
6. The port's ``cli/train_scene.py`` on ``examples/synth_scene`` with the
   flags of ``scripts/run_synth_e2e.sh`` stage 1 (2900 iterations): test
   PSNR at each test iteration, ≥ 35 dB at the end; the saved PLY renders
   through ``cli/render.py`` to non-constant PNGs.

The second-to-last line of output is a JSON object describing the kernels
(times, launches, bound); the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without CUDA, or without the package beside this file, it exits non-zero
before printing a result.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 3.35 TB/s, fp32 outside
# the tensor cores 67 TFLOP/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

TOL_COLOR, TOL_FINAL_T, TOL_GRAD = 1e-4, 5e-5, 2e-4
N_FULL, W_FULL, H_FULL, SH_DEGREE, N_CAMS = 3_000_000, 1297, 840, 3, 8
N_SUBSET_TILES = 64
N_TRAIN_STEPS, N_TRAIN_VIEWS = 10, 4
# scripts/run_synth_e2e.sh stage 1, flag for flag.
SYNTH_E2E_FLAGS = [
    "--iterations", "2900", "--eval",
    "--test_iterations", "500", "1000", "1500", "2000", "2500", "2900",
    "--densify_grad_threshold", "0.001", "--save_iterations", "2900", "--disable_viewer",
]
PSNR_GATE = 35.0


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, warmup=2, iters=10) -> list[float]:
    """Per-call device times in ms from CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


# ---------------------------------------------------------------------------
# Scenes and the blend inputs the render path builds
# ---------------------------------------------------------------------------


def random_scene(n, seed, device, radius=1.0, log_scale=(-4.9, 0.5), sh_degree=SH_DEGREE):
    """Seeded Gaussians in a ball (pre-activation parameters, PLY layout)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device)

    direction = randn(n, 3)
    direction = direction / direction.norm(dim=1, keepdim=True)
    r = radius * torch.rand(n, 1, generator=g, device=device) ** (1.0 / 3.0)
    rest = (sh_degree + 1) ** 2 - 1
    return dict(
        xyz=direction * r,
        features_dc=0.8 * randn(n, 1, 3),
        features_rest=0.2 * randn(n, rest, 3),
        scaling=log_scale[0] + log_scale[1] * randn(n, 3),
        rotation=randn(n, 4),
        opacity=1.5 * randn(n, 1),
    )


def orbit_cameras(count, width, height, distance=2.6, fovy=0.9):
    from seganygaussians_torch.data.cameras import orbit_camera_params

    return [
        orbit_camera_params(np.zeros(3), distance, 2 * math.pi * i / count, 0.25, fovy, width, height)
        for i in range(count)
    ]


def blend_inputs(xyz, opacity, scales, rotations, colors, camera, capacity, bg, tile_size=16):
    """The rasterizer's inputs to the blend, built by the same public
    functions ``ops/rasterize.py`` calls."""
    from seganygaussians_torch.ops.binning import expand_slots, sort_instances
    from seganygaussians_torch.ops.projection import preprocess

    prep = preprocess(xyz, camera, scales=scales, rotations=rotations,
                      tile_size=tile_size, opacities=opacity)
    grid_x = (camera.width + tile_size - 1) // tile_size
    grid_y = (camera.height + tile_size - 1) // tile_size
    plan = expand_slots(prep, grid_x, grid_y, capacity)
    check(not plan.overflow, f"capacity {capacity} overflowed ({plan.num_instances} kept)")
    perm = plan.depth_perm
    n = xyz.shape[0]
    gauss_s, tile_s, tile_starts = sort_instances(plan.slot_rank, plan.slot_tile, n, grid_x * grid_y)
    d = dict(
        gauss_s=gauss_s, tile_s=tile_s, tile_starts=tile_starts,
        means2d=prep.means2d[perm].contiguous(), conics=prep.conics[perm].contiguous(),
        opacities=opacity[perm].contiguous(), colors=colors[perm].contiguous(),
        bg=bg, grid=(grid_x, grid_y, tile_size), num_instances=plan.num_instances,
    )
    d["table"] = torch.cat(
        [d["means2d"], d["conics"], d["opacities"][:, None], d["colors"]], dim=1
    ).contiguous()
    return d


def run_kernel(d):
    from seganygaussians_torch.ops.blend_cuda import FORWARD

    return FORWARD(d["gauss_s"], d["tile_starts"], d["table"], d["bg"], d["grid"][0], d["grid"][2])


def run_plain(d, gauss_id, tile_id, tile_starts):
    from seganygaussians_torch.ops import blend as blend_torch

    n = d["table"].shape[0]
    return blend_torch.blend(
        gauss_id.clamp_max(n - 1), tile_id, tile_starts, d["means2d"], d["conics"],
        d["opacities"], d["colors"], d["bg"], *d["grid"],
    )


def subset(d, tiles):
    """Instance arrays holding only ``tiles``' ranges (``tiles`` ascending),
    with range starts for them.  Tiles are independent, so both the kernel
    and the plain version give those tiles exactly as in the full frame."""
    starts = d["tile_starts"].long()
    tiles = tiles.to(starts.device)
    lo, hi = starts[tiles], starts[tiles + 1]
    idx = torch.cat([torch.arange(int(a), int(b), device=starts.device)
                     for a, b in zip(lo.tolist(), hi.tolist())])
    counts = torch.zeros_like(starts[1:])
    counts[tiles] = hi - lo
    sub_starts = torch.cat([starts[:1] * 0, torch.cumsum(counts, 0)]).to(torch.int32)
    return d["gauss_s"][idx].contiguous(), d["tile_s"][idx], sub_starts


def compare(kernel_out, plain_out, rows=None) -> float:
    """Raise unless the kernel agrees with the plain version; return the
    largest absolute color/final_t difference."""
    tiles, final_t, n_contrib = kernel_out
    if rows is not None:
        tiles, final_t, n_contrib = tiles[rows], final_t[rows], n_contrib[rows]
        plain_out = type(plain_out)(*(x[rows] for x in plain_out))
    check(bool(torch.isfinite(tiles).all()), "kernel produced non-finite colors")
    err_c = float((tiles - plain_out.tiles).abs().max())
    err_t = float((final_t - plain_out.final_t).abs().max())
    n_bad = int((n_contrib != plain_out.n_contrib).sum())
    check(err_c <= TOL_COLOR, f"color differs from the plain version by {err_c}")
    check(err_t <= TOL_FINAL_T, f"final_t differs from the plain version by {err_t}")
    check(n_bad == 0, f"n_contrib differs from the plain version at {n_bad} pixels")
    return max(err_c, err_t)


def work_counts(d, n_contrib) -> tuple[int, int]:
    """(visited, included) (instance, pixel) pairs of this frame.

    A pixel must evaluate each instance of its tile up to the one that ends
    its march: instance j is visited while the product of (1 − α) over the
    contributing instances before it is ≥ 1e-4.  Counted exactly, chunk by
    chunk of whole tiles."""
    from seganygaussians_torch.ops import blend as blend_torch

    starts = d["tile_starts"].long().cpu().tolist()
    starts_dev = d["tile_starts"].long()
    num_tiles = len(starts) - 1
    grid_x, _, ts = d["grid"]
    n = d["table"].shape[0]
    visited, t0 = 0, 0
    log_eps = math.log(blend_torch.T_EPS)
    while t0 < num_tiles:
        t1 = t0 + 1
        while t1 < num_tiles and starts[t1 + 1] - starts[t0] <= (1 << 17):
            t1 += 1
        s, e = int(starts[t0]), int(starts[t1])
        if e > s:
            g = d["gauss_s"][s:e].clamp_max(n - 1)
            tile = d["tile_s"][s:e]
            alpha = blend_torch.instance_alphas(
                g, tile, d["means2d"], d["conics"], d["opacities"], grid_x, ts
            )
            log1m = torch.log1p(-alpha).double()
            cum = torch.cumsum(log1m, 0)
            seg0 = starts_dev[tile] - s  # first row of each tile
            base = torch.where((seg0 > 0)[:, None], cum[(seg0 - 1).clamp_min(0)],
                               torch.zeros_like(cum[:1]))
            visited += int(((cum - log1m - base) >= log_eps).sum())
        t0 = t1
    return visited, int(n_contrib.sum())


def bound(d, visited, included):
    """Least time for this frame's work on the card, and what bounds it."""
    c = d["colors"].shape[1]
    num_tiles = d["tile_starts"].shape[0] - 1
    p = d["grid"][2] ** 2
    n = d["table"].shape[0]
    bytes_moved = (
        d["num_instances"] * 8 + (num_tiles + 1) * 4 + n * (6 + c) * 4 + c * 4  # inputs
        + num_tiles * p * (c + 2) * 4  # outputs
    )
    # 14 fp32 operations per visited pair (offsets, quadratic form, exp,
    # opacity, clamp) and 2·C + 3 per included pair (transmittance, weight,
    # color accumulation).
    ops = 14 * visited + (2 * c + 3) * included
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), bytes_moved, ops


def frame_stages(params, camera, capacity, device) -> dict[str, float]:
    """Median device ms of each stage of one RGB frame, each stage run alone
    on the previous stage's outputs (the split of ``render.render``)."""
    from seganygaussians_torch.models import gaussians as gm
    from seganygaussians_torch.ops import blend as blend_torch
    from seganygaussians_torch.ops.binning import expand_slots, sort_instances
    from seganygaussians_torch.ops.blend_cuda import FORWARD
    from seganygaussians_torch.ops.projection import preprocess
    from seganygaussians_torch.ops.sh import eval_sh_color

    xyz, opa = params.xyz, gm.get_opacity(params)[:, 0]
    scales, rots, shs = gm.get_scaling(params), gm.get_rotation(params), gm.get_shs(params)
    _, _, center = camera.tensors(device)
    grid_x, grid_y, ts = (camera.width + 15) // 16, (camera.height + 15) // 16, 16
    r = {}

    def stage(name, fn):
        out = fn()
        r[name] = float(np.median(cuda_time_ms(fn, warmup=1, iters=5)))
        return out

    stage("activations", lambda: (gm.get_opacity(params), gm.get_scaling(params),
                                  gm.get_rotation(params), gm.get_shs(params)))
    prep = stage("preprocess", lambda: preprocess(xyz, camera, scales=scales, rotations=rots,
                                                  opacities=opa))
    colors = stage("sh_eval", lambda: eval_sh_color(SH_DEGREE, shs, xyz, center))
    plan = stage("expand_slots", lambda: expand_slots(prep, grid_x, grid_y, capacity))
    gauss_s, _, starts = stage("sort_instances", lambda: sort_instances(
        plan.slot_rank, plan.slot_tile, xyz.shape[0], grid_x * grid_y))
    perm = plan.depth_perm
    table = stage("gather_fields", lambda: torch.cat(
        [prep.means2d[perm], prep.conics[perm], opa[perm][:, None], colors[perm]], 1
    ).contiguous())
    bg = torch.zeros(3, device=device)
    tiles, _, _ = stage("blend_kernel", lambda: FORWARD(gauss_s, starts, table, bg, grid_x, ts))
    stage("tiles_to_image", lambda: blend_torch.tiles_to_image(
        tiles, grid_x, grid_y, ts, camera.width, camera.height).contiguous())
    return r


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_small(device) -> dict[int, float]:
    """Kernel vs plain version, whole frames, C ∈ {3, 4, 32}."""
    from seganygaussians_torch.models import gaussians as gm
    from seganygaussians_torch.ops.camera import make_camera
    from seganygaussians_torch.ops.sh import eval_sh_color

    errors, frames = {}, {}
    for c, seed in ((3, 1), (4, 2), (32, 3)):
        s = random_scene(2000, seed, device, radius=1.0, log_scale=(-3.3, 0.5))
        params = gm.GaussianParams(**s)
        xyz, opa = params.xyz, gm.get_opacity(params)[:, 0]
        cam = make_camera(np.eye(3), np.array([0.0, 0.0, 3.0]), fovx=1.0, fovy=0.78,
                          width=256, height=192)
        _, _, center = cam.tensors(device)
        rgb = eval_sh_color(SH_DEGREE, gm.get_shs(params), xyz, center)
        g = torch.Generator(device=device).manual_seed(seed)
        colors = rgb if c == 3 else torch.cat(
            [rgb, torch.rand(xyz.shape[0], c - 3, generator=g, device=device)], 1
        )
        bg = torch.linspace(0.1, 0.9, c, device=device)
        d = blend_inputs(xyz, opa, gm.get_scaling(params), gm.get_rotation(params),
                         colors, cam, 1 << 18, bg)
        out = run_kernel(d)
        plain = run_plain(d, d["gauss_s"], d["tile_s"], d["tile_starts"])
        torch.cuda.synchronize()
        err = compare(out, plain)
        errors[c] = err
        print(f"phase 1: C={c}: {d['num_instances']} instances, max n_contrib "
              f"{int(out[2].max())}, max |kernel - plain| {err:.3g}")
        check(int(out[2].max()) > 10, "small scene too thin to test the march")
        frames[c] = d
    return errors, frames


def phase_full(device, card, small_errors):
    """3M Gaussians, SH degree 3, 1297×840, through render.render and
    render.render_features."""
    from seganygaussians_torch import render as R
    from seganygaussians_torch.models import gaussians as gm
    from seganygaussians_torch.ops.binning import suggest_capacity
    from seganygaussians_torch.ops.blend_cuda import FORWARD
    from seganygaussians_torch.ops.projection import preprocess
    from seganygaussians_torch.ops.rasterize import RasterConfig
    from seganygaussians_torch.ops.sh import eval_sh_color

    s = random_scene(N_FULL, 42, device)
    state = gm.from_dense(*(s[k].cpu().numpy() for k in (
        "xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")), device=device)
    p = state.params
    opa = gm.get_opacity(p)[:, 0]
    scales, rots = gm.get_scaling(p), gm.get_rotation(p)
    g = torch.Generator(device=device).manual_seed(7)
    feats = torch.randn(N_FULL, 32, generator=g, device=device)
    cams = orbit_cameras(N_CAMS, W_FULL, H_FULL)

    with torch.no_grad():
        totals = [int(preprocess(p.xyz, cam, scales=scales, rotations=rots, opacities=opa)
                      .tiles_touched.sum()) for cam in cams]
        capacity = suggest_capacity(max(totals))
        config = RasterConfig(capacity=capacity)
        bg = torch.zeros(3, device=device)
        print(f"phase 2: {N_FULL} Gaussians, {W_FULL}x{H_FULL}, instances per view "
              f"{min(totals)}..{max(totals)}, capacity {capacity}")

        def render_rgb(cam):
            out = R.render(cam, state, bg, active_sh_degree=SH_DEGREE, config=config)
            check(not out["overflow"], "RGB render overflowed its capacity")
            return out

        def render_feat(cam):
            out = R.render_features(cam, p.xyz, opa, scales, rots, feats, config=config)
            check(not out["overflow"], "feature render overflowed its capacity")
            return out

        # Warm-up outside the counted window (allocator, first launches).
        render_rgb(cams[0])
        render_feat(cams[0])
        torch.cuda.synchronize()

        # --- the main path: counts at 0 just before, read just after.
        FORWARD.reset_counts()
        frame_ms = {"rgb": [], "feat": []}
        for kind, fn in (("rgb", render_rgb), ("feat", render_feat)):
            for cam in cams:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(cam)
                end.record()
                torch.cuda.synchronize()
                frame_ms[kind].append(start.elapsed_time(end))
                img = out["render"]
                check(img.shape == (H_FULL, W_FULL, 3 if kind == "rgb" else 32),
                      f"{kind} render shape {tuple(img.shape)}")
                check(bool(torch.isfinite(img).all()), f"{kind} render not finite")
        torch.cuda.synchronize()
        launches = dict(FORWARD.launches_by_channels)
        total_launches = FORWARD.launches
        # ---
        check(launches[3] > 0 and launches[32] > 0,
              f"the render path did not launch the kernel: {launches}")
        per_frame = total_launches / (2 * N_CAMS)
        print(f"phase 2: kernel launches over the renders {launches} "
              f"({per_frame:g} per frame); median frame ms RGB "
              f"{float(np.median(frame_ms['rgb'])):.3f}, C=32 "
              f"{float(np.median(frame_ms['feat'])):.3f}  [{card}]")
        img = render_rgb(cams[0])["render"]
        check(float(img.std()) > 0.01, "full-size RGB render is constant")
        stages = frame_stages(p, cams[0], capacity, device)
        print(f"phase 2: RGB frame stages, median device ms each: "
              f"{json.dumps({k: round(v, 4) for k, v in stages.items()})}  [{card}]")

        # --- kernel alone at the main path's shapes, and against the plain
        # version on 64 seeded tiles.
        entries, worst, frames = [], 0.0, {}
        _, _, center = cams[0].tensors(device)
        rgb = eval_sh_color(SH_DEGREE, gm.get_shs(p), p.xyz, center)
        for name, colors in (("blend_fwd[C=3]", rgb), ("blend_fwd[C=32]", feats)):
            c = colors.shape[1]
            d = blend_inputs(p.xyz, opa, scales, rots, colors, cams[0], capacity,
                             torch.zeros(c, device=device))
            out = run_kernel(d)
            kernel_ms = float(np.median(cuda_time_ms(lambda: run_kernel(d), warmup=2, iters=10)))
            nonempty = torch.nonzero(d["tile_starts"][1:] > d["tile_starts"][:-1]).flatten().cpu()
            pick = torch.randperm(nonempty.numel(), generator=torch.Generator().manual_seed(c))
            tiles = nonempty[pick[:N_SUBSET_TILES]].sort().values
            sub = subset(d, tiles)
            plain = run_plain(d, *sub)
            torch.cuda.synchronize()
            err = compare(out, plain, rows=tiles.to(device))
            worst = max(worst, err)
            plain_ms = float(np.median(cuda_time_ms(lambda: run_plain(d, *sub), warmup=1, iters=3)))
            sub_d = dict(d, gauss_s=sub[0], tile_starts=sub[2])
            sub_kernel_ms = float(np.median(cuda_time_ms(lambda: run_kernel(sub_d), warmup=1, iters=5)))
            visited, included = work_counts(d, out[2])
            frames[c] = (d, tiles, visited, included)
            bound_ms, bound_by, nbytes, ops = bound(d, visited, included)
            print(f"phase 2: {name}: {d['num_instances']} instances, kernel {kernel_ms:.3f} ms "
                  f"(full frame), bound {bound_ms:.4f} ms by {bound_by} ({nbytes} B, {ops} ops; "
                  f"{visited} visited / {included} included pairs); 64-tile subset: kernel "
                  f"{sub_kernel_ms:.3f} ms, plain {plain_ms:.3f} ms (no yardstick of speed); "
                  f"max |kernel - plain| {err:.3g}  [{card}]")
            entries.append({
                "name": name,
                "route": "cuda",
                "source": "seganygaussians_torch/csrc/blend_fwd.cu",
                "replaces": "seganygaussians_tpu/ops/blend_pallas.py:252",
                "launches": launches[c],
                "max_abs_err": max(err, small_errors[c]),
                "ms": kernel_ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": None,
            })
    return entries, worst, frames, s, capacity


def phase_cli(device):
    """The port's batch-render CLI on examples/synth_scene."""
    from PIL import Image

    from seganygaussians_torch.cli import render as cli
    from seganygaussians_torch.data import ply
    from seganygaussians_torch.ops.blend_cuda import FORWARD

    scene_dir = os.path.join(ROOT, "examples", "synth_scene")
    pts, _ = ply.load_point_cloud_ply(os.path.join(scene_dir, "sparse", "0", "points3D.ply"))
    rng = np.random.default_rng(11)
    n = 20_000
    s = random_scene(n, 11, device, sh_degree=3)
    xyz = pts[rng.integers(0, len(pts), n)] + rng.normal(0.0, 0.05, (n, 3))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        ply.save_gaussians_ply(
            os.path.join(tmp, "point_cloud", "iteration_1", "scene_point_cloud.ply"),
            xyz.astype(np.float32), s["features_dc"].cpu().numpy(),
            s["features_rest"].cpu().numpy(), s["opacity"].cpu().numpy(),
            np.log(rng.uniform(0.01, 0.05, (n, 3))).astype(np.float32),
            s["rotation"].cpu().numpy(),
        )
        FORWARD.reset_counts()
        check(cli.main(["-s", scene_dir, "-m", tmp, "--device", str(device)]) == 0,
              "cli/render.py failed")
        torch.cuda.synchronize()
        launches = FORWARD.launches
        out_dir = os.path.join(tmp, "scene", "ours_1", "train", "renders")
        pngs = sorted(os.listdir(out_dir))
        n_views = len(os.listdir(os.path.join(scene_dir, "images")))
        check(len(pngs) == n_views, f"{len(pngs)} PNGs for {n_views} cameras")
        for name in pngs:
            arr = np.asarray(Image.open(os.path.join(out_dir, name)))
            check(arr.std() > 1.0, f"{name} is constant")
        check(launches >= n_views, f"CLI launched the kernel {launches} times")
        print(f"phase 3: cli/render.py wrote {len(pngs)} PNGs, kernel launches {launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def grad_inputs(d, seed):
    """Seeded cotangents for a frame: g_tiles (T, P, C), g_final_t (T, P)."""
    num_tiles = d["tile_starts"].shape[0] - 1
    p, c = d["grid"][2] ** 2, d["colors"].shape[1]
    g = torch.Generator(device=d["table"].device).manual_seed(seed)
    return (torch.randn(num_tiles, p, c, generator=g, device=d["table"].device),
            torch.randn(num_tiles, p, generator=g, device=d["table"].device))


def run_backward(d, gauss_s, tile_starts, g_tiles, g_final_t):
    """Forward kernel for the residuals, then the backward kernel."""
    from seganygaussians_torch.ops.blend_cuda import FORWARD, blend_backward

    grid_x, _, ts = d["grid"]
    tiles, final_t, _ = FORWARD(gauss_s, tile_starts, d["table"], d["bg"], grid_x, ts)
    return blend_backward(gauss_s, tile_starts, d["table"], d["bg"], tiles, final_t,
                          g_tiles, g_final_t, grid_x, ts)


def run_backward_plain(d, gauss_s, tile_starts, g_tiles, g_final_t):
    from seganygaussians_torch.ops.blend_cuda import blend_backward_plain

    return blend_backward_plain(gauss_s, tile_starts, d["table"], d["bg"], g_tiles,
                                g_final_t, d["grid"])


def compare_grads(got, want) -> float:
    """Raise unless every column of d_table and d_bg is within TOL_GRAD of
    that column's largest |plain|; return the largest absolute difference."""
    worst = 0.0
    for name, a, b in (("d_table", got[0], want[0]), ("d_bg", got[1][None], want[1][None])):
        check(bool(torch.isfinite(a).all()), f"backward kernel: non-finite {name}")
        scale = b.abs().amax(dim=0) + 1e-6
        rel = float(((a - b).abs() / scale).max())
        check(rel <= TOL_GRAD, f"backward kernel: {name} differs from the plain version by "
              f"{rel:.3g} of a column's max (tolerance {TOL_GRAD})")
        worst = max(worst, float((a - b).abs().max()))
    return worst


def bound_backward(d, visited, included):
    """Least time for the backward's work on this frame, and what bounds it."""
    c = d["colors"].shape[1]
    num_tiles = d["tile_starts"].shape[0] - 1
    p = d["grid"][2] ** 2
    n = d["table"].shape[0]
    bytes_moved = (
        d["num_instances"] * 8 + (num_tiles + 1) * 4 + n * (6 + c) * 4 + c * 4  # ranks, table
        + num_tiles * p * (2 * c + 2) * 4  # residuals tiles, final_t; g_tiles, g_final_t
        + n * (6 + c) * 4  # d_table written
    )
    # 14 fp32 operations per visited pair (the forward's alpha); per included
    # pair 3·C + 29 for the gradient terms (g·c, suffix, dL/dα, the mean,
    # conic, opacity and color partials, transmittance) and 6 + C adds to sum
    # them over the tile's pixels.
    ops = 14 * visited + (4 * c + 35) * included
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), bytes_moved, ops


def phase_backward(card, small_frames, full_frames) -> tuple[list, float]:
    """Backward kernel vs plain version: whole small frames, then 64 tiles of
    the full-size frames."""
    from seganygaussians_torch.ops.blend_cuda import BACKWARD, FORWARD

    worst, small_err = 0.0, {}
    for c, d in small_frames.items():
        g_tiles, g_final_t = grad_inputs(d, 100 + c)
        got = run_backward(d, d["gauss_s"], d["tile_starts"], g_tiles, g_final_t)
        want = run_backward_plain(d, d["gauss_s"], d["tile_starts"], g_tiles, g_final_t)
        torch.cuda.synchronize()
        small_err[c] = compare_grads(got, want)
        check(float(want[0][:, :6].abs().amax(dim=0).min()) > 0, "a geometry column is zero")
        print(f"phase 4: C={c} whole 256x192 frame: max |kernel - plain| {small_err[c]:.3g}")
        worst = max(worst, small_err[c])

    entries = []
    for c, (d, tiles, visited, included) in sorted(full_frames.items()):
        grid_x, _, ts = d["grid"]
        g_tiles, g_final_t = grad_inputs(d, 200 + c)
        sub = subset(d, tiles)
        got = run_backward(d, sub[0], sub[2], g_tiles, g_final_t)
        want = run_backward_plain(d, sub[0], sub[2], g_tiles, g_final_t)
        torch.cuda.synchronize()
        err = compare_grads(got, want)
        worst = max(worst, err)
        plain_ms = float(np.median(cuda_time_ms(
            lambda: run_backward_plain(d, sub[0], sub[2], g_tiles, g_final_t),
            warmup=1, iters=3)))
        # The kernel alone at the full frame, on the forward's residuals.
        res = FORWARD(d["gauss_s"], d["tile_starts"], d["table"], d["bg"], grid_x, ts)
        args = (d["gauss_s"], d["tile_starts"], d["table"], d["bg"], g_tiles, g_final_t,
                res[0], res[1], grid_x, ts)
        kernel_ms = float(np.median(cuda_time_ms(lambda: BACKWARD(*args), warmup=2, iters=10)))
        bound_ms, bound_by, nbytes, ops = bound_backward(d, visited, included)
        print(f"phase 4: blend_bwd[C={c}]: {d['num_instances']} instances, kernel "
              f"{kernel_ms:.3f} ms (full frame), bound {bound_ms:.4f} ms by {bound_by} "
              f"({nbytes} B, {ops} ops; {visited} visited / {included} included pairs); "
              f"64-tile subset: plain {plain_ms:.3f} ms (no yardstick of speed); "
              f"max |kernel - plain| {err:.3g}  [{card}]")
        entries.append({
            "name": f"blend_bwd[C={c}]",
            "route": "cuda",
            "source": "seganygaussians_torch/csrc/blend_bwd.cu",
            "replaces": "seganygaussians_tpu/ops/blend_pallas.py:397",
            "launches": 0,  # set from phase 5's main-path run
            "max_abs_err": max(err, small_err.get(c, 0.0)),
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
        })
    return entries, worst


def fixed_view_loss(state, cam, gt, bg, config) -> float:
    from seganygaussians_torch.ops import losses
    from seganygaussians_torch.train.scene_trainer import _render

    with torch.no_grad():
        out = _render(state.params, state.alive, cam, bg, SH_DEGREE, config)
        img = out.color
        return float(0.8 * losses.l1_loss(img, gt) + 0.2 * (1.0 - losses.ssim(img, gt)))


def train_stages(state, cam, gt, bg, hyper, config, extent) -> dict[str, float]:
    """Device ms of each stage of one train_step (the split of
    ``scene_trainer.train_step``), with CUDA events between the stages and
    around the backward kernel's launch."""
    from seganygaussians_torch.models import gaussians as gm
    from seganygaussians_torch.models import optim
    from seganygaussians_torch.ops import blend_cuda, losses
    from seganygaussians_torch.train.scene_trainer import _render

    kernel_events = []
    real = blend_cuda.BACKWARD

    class Timed:
        def __call__(self, *args):
            ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev[0].record()
            out = real(*args)
            ev[1].record()
            kernel_events.append(ev)
            return out

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    blend_cuda.BACKWARD = Timed()
    try:
        leaves = [p.detach().requires_grad_(True) for p in state.params]
        params = gm.GaussianParams(*leaves)
        ndc0 = torch.zeros((params.xyz.shape[0], 2), device=params.xyz.device,
                           requires_grad=True)
        ev[0].record()
        out = _render(params, state.alive, cam, bg, SH_DEGREE, config, ndc0)
        ev[1].record()
        loss = 0.8 * losses.l1_loss(out.color, gt) + 0.2 * (1.0 - losses.ssim(out.color, gt))
        ev[2].record()
        *grads, ndc_grad = torch.autograd.grad(loss, leaves + [ndc0])
        ev[3].record()
        with torch.no_grad():
            new_params, new_opt = optim.adam_update(
                gm.GaussianParams(*grads), state.opt, state.params,
                gm.make_lr_tree(hyper, extent, 1))
            gm.add_densification_stats(state._replace(params=new_params, opt=new_opt),
                                       ndc_grad, out.radii)
        ev[4].record()
        torch.cuda.synchronize()
    finally:
        blend_cuda.BACKWARD = real
    check(len(kernel_events) == 1, f"{len(kernel_events)} backward launches in one step")
    kernel = kernel_events[0][0].elapsed_time(kernel_events[0][1])
    backward = ev[2].elapsed_time(ev[3])
    return {"forward_render": ev[0].elapsed_time(ev[1]), "loss_ssim": ev[1].elapsed_time(ev[2]),
            "backward_kernel": kernel, "autograd_rest": backward - kernel,
            "adam_stats": ev[3].elapsed_time(ev[4]), "step_total": ev[0].elapsed_time(ev[4])}


def phase_train(device, card, s, capacity) -> dict[int, int]:
    """train_step at full width on phase 2's scene; returns the backward
    kernel's launches by channel count over the main-path window."""
    from seganygaussians_torch import render as R
    from seganygaussians_torch.models import gaussians as gm
    from seganygaussians_torch.ops.binning import suggest_capacity
    from seganygaussians_torch.ops.blend_cuda import BACKWARD, FORWARD
    from seganygaussians_torch.ops.knn import mean_sq_dist_to_3nn
    from seganygaussians_torch.ops.projection import preprocess
    from seganygaussians_torch.ops.rasterize import RasterConfig
    from seganygaussians_torch.train.scene_trainer import train_step

    keys = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
    cap = N_FULL + N_FULL // 4  # dead slots for densification
    state = gm.with_training_fields(
        gm.from_dense(*(s[k].cpu().numpy() for k in keys), capacity=cap, device=device))
    # Dead slots get identity quaternions, as create_from_points pads them:
    # a zero quaternion's normalisation has a NaN gradient.
    state.params.rotation[N_FULL:, 0] = 1.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist2 = mean_sq_dist_to_3nn(state.params.xyz[:N_FULL])
    torch.cuda.synchronize()
    knn_s = time.perf_counter() - t0
    check(bool(torch.isfinite(dist2).all()) and float(dist2.min()) >= 0, "3-NN distances")
    print(f"phase 5: scale init mean_sq_dist_to_3nn on {N_FULL} points: {knn_s * 1e3:.1f} ms, "
          f"median implied scale {float(dist2.median().sqrt()):.5f}  [{card}]")

    # Targets: a seeded perturbed copy of the scene, rendered at full width.
    g = torch.Generator(device=device).manual_seed(17)
    target = dict(s)
    target["xyz"] = s["xyz"] + 0.002 * torch.randn(s["xyz"].shape, generator=g, device=device)
    target["features_dc"] = s["features_dc"] + 0.15 * torch.randn(
        s["features_dc"].shape, generator=g, device=device)
    target["opacity"] = s["opacity"] + 0.3 * torch.randn(s["opacity"].shape, generator=g,
                                                         device=device)
    tstate = gm.from_dense(*(target[k].cpu().numpy() for k in keys), device=device)
    cams = orbit_cameras(N_TRAIN_VIEWS, W_FULL, H_FULL)
    bg = torch.zeros(3, device=device)
    with torch.no_grad():
        tp = tstate.params
        totals = [int(preprocess(tp.xyz, cam, scales=gm.get_scaling(tp),
                                 rotations=gm.get_rotation(tp),
                                 opacities=gm.get_opacity(tp)[:, 0]).tiles_touched.sum())
                  for cam in cams]
        config = RasterConfig(capacity=max(capacity, suggest_capacity(max(totals))))
        gts = []
        for cam in cams:
            out = R.render(cam, tstate, bg, active_sh_degree=SH_DEGREE, config=config)
            check(not out["overflow"], "target render overflowed")
            gts.append(out["render"].clamp(0.0, 1.0).contiguous())
    del tstate
    hyper = gm.TrainHyper()
    extent = 2.6 * 1.1  # NeRF++ radius of the orbit
    loss_before = fixed_view_loss(state, cams[0], gts[0], bg, config)

    # Warm-up step outside the counted window (allocator, first launches).
    warm, _ = train_step(state, cams[1], gts[1], bg, 1, extent, SH_DEGREE, hyper, config)
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    feats = torch.randn(N_FULL, 32, generator=g, device=device).requires_grad_(True)
    feat_target = torch.rand(H_FULL, W_FULL, 32, generator=g, device=device)
    p = state.params

    # --- the main path: counts at 0 just before, read just after.
    FORWARD.reset_counts()
    BACKWARD.reset_counts()
    step_ms, host_ms = [], []
    for step in range(1, N_TRAIN_STEPS + 1):
        i = (step - 1) % N_TRAIN_VIEWS
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        start.record()
        state, metrics = train_step(state, cams[i], gts[i], bg, step, extent, SH_DEGREE,
                                    hyper, config)
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - h0) * 1e3)
        step_ms.append(start.elapsed_time(end))
        check(not metrics["overflow"], f"step {step} overflowed its capacity")
        check(not bool(metrics["nonfinite"]), f"step {step} was non-finite")
    bwd_rgb = dict(BACKWARD.launches_by_channels)
    fwd_rgb = FORWARD.launches
    # The C = 32 gradient of the feature render (the contrastive path's kernel
    # instance), through the public entry point.
    out = R.render_features(cams[0], p.xyz[:N_FULL], gm.get_opacity(p)[:N_FULL, 0],
                            gm.get_scaling(p)[:N_FULL], gm.get_rotation(p)[:N_FULL], feats,
                            config=config)
    ((out["render"] - feat_target) ** 2).mean().backward()
    torch.cuda.synchronize()
    launches = dict(BACKWARD.launches_by_channels)
    # ---
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(bwd_rgb[3] == N_TRAIN_STEPS and sum(bwd_rgb.values()) == N_TRAIN_STEPS,
          f"backward kernel launches {bwd_rgb} over {N_TRAIN_STEPS} train steps")
    check(fwd_rgb >= N_TRAIN_STEPS, f"forward kernel launches {fwd_rgb} < {N_TRAIN_STEPS}")
    check(launches[32] == 1, f"feature-render backward launches {launches}")
    check(bool(torch.isfinite(feats.grad).all()) and float(feats.grad.abs().max()) > 0,
          "feature gradient")
    for name, leaf in zip(("params", "mu", "nu"), (state.params, state.opt.mu, state.opt.nu)):
        check(all(bool(torch.isfinite(x).all()) for x in leaf), f"non-finite {name}")
    loss_after = fixed_view_loss(state, cams[0], gts[0], bg, config)
    check(loss_after < loss_before, f"fixed-view loss did not drop: {loss_before} -> "
          f"{loss_after}")
    print(f"phase 5: {N_TRAIN_STEPS} train steps at {W_FULL}x{H_FULL}, {N_FULL} Gaussians: "
          f"fixed-view loss {loss_before:.5f} -> {loss_after:.5f}; ms/step median "
          f"{float(np.median(step_ms)):.3f} (device, CUDA events; host "
          f"{float(np.median(host_ms)):.3f}); forward launches {fwd_rgb}, backward "
          f"launches {bwd_rgb}; peak memory {peak_gb:.2f} GB  [{card}]")
    stages = train_stages(state, cams[0], gts[0], bg, hyper, config, extent)
    print(f"phase 5: train-step stages, device ms: "
          f"{json.dumps({k: round(v, 3) for k, v in stages.items()})}  [{card}]")

    alive_before = int(state.alive.sum())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    from seganygaussians_torch.train.scene_trainer import densify_step

    dstate = densify_step(state, torch.Generator(device=device).manual_seed(5), extent,
                          20.0, hyper)
    torch.cuda.synchronize()
    dens_ms = (time.perf_counter() - t0) * 1e3
    alive_after = int(dstate.alive.sum())
    check(all(bool(torch.isfinite(x).all()) for x in dstate.params), "densify: non-finite")
    print(f"phase 5: densify_and_prune at {cap} capacity: {dens_ms:.1f} ms, live Gaussians "
          f"{alive_before} -> {alive_after}  [{card}]")
    return {3: bwd_rgb[3], 32: launches[32]}


def phase_train_cli(device, card) -> None:
    """The port's trainer CLI on examples/synth_scene with the e2e flags, then
    the saved PLY through cli/render.py."""
    from PIL import Image

    from seganygaussians_torch.cli import render as render_cli
    from seganygaussians_torch.cli import train_scene as train_cli
    from seganygaussians_torch.ops.blend_cuda import BACKWARD

    scene_dir = os.path.join(ROOT, "examples", "synth_scene")
    iterations = int(SYNTH_E2E_FLAGS[SYNTH_E2E_FLAGS.index("--iterations") + 1])
    i = SYNTH_E2E_FLAGS.index("--test_iterations") + 1
    test_its = []
    while i < len(SYNTH_E2E_FLAGS) and not SYNTH_E2E_FLAGS[i].startswith("--"):
        test_its.append(int(SYNTH_E2E_FLAGS[i]))
        i += 1
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        BACKWARD.reset_counts()
        t0 = time.perf_counter()
        check(train_cli.main(["-s", scene_dir, "-m", tmp, "--device", str(device),
                              *SYNTH_E2E_FLAGS]) == 0, "cli/train_scene.py failed")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        records = [json.loads(line) for line in open(os.path.join(tmp, "metrics.jsonl"))]
        psnr = {r["iter"]: r["test/psnr"] for r in records if "test/psnr" in r}
        alive = {r["iter"]: int(r["scene/n_alive"]) for r in records if "scene/n_alive" in r}
        check(sorted(psnr) == test_its, f"test iterations {psnr}")
        for it in sorted(psnr):
            print(f"phase 6: iteration {it}: test PSNR {psnr[it]:.3f} dB, "
                  f"{alive[it]} live Gaussians")
        print(f"phase 6: {iterations} iterations in {wall:.1f} s "
              f"({wall / iterations * 1e3:.2f} ms/iteration wall, evaluations and save "
              f"included), backward launches {BACKWARD.launches}  [{card}]")
        check(BACKWARD.launches == iterations,
              f"backward launches {BACKWARD.launches} != {iterations}")
        check(psnr[iterations] >= PSNR_GATE,
              f"final test PSNR {psnr[iterations]:.2f} < {PSNR_GATE} dB")
        ply = os.path.join(tmp, "point_cloud", f"iteration_{iterations}",
                           "scene_point_cloud.ply")
        check(os.path.exists(ply), f"{ply} not written")
        check(render_cli.main(["-s", scene_dir, "-m", tmp, "--iteration", str(iterations),
                               "--device", str(device)]) == 0, "cli/render.py failed")
        n_png = 0
        renders = os.path.join(tmp, "scene", f"ours_{iterations}")
        for split in sorted(os.listdir(renders)):
            out_dir = os.path.join(renders, split, "renders")
            for name in sorted(os.listdir(out_dir)):
                arr = np.asarray(Image.open(os.path.join(out_dir, name)))
                check(arr.std() > 1.0, f"{split}/{name} is constant")
                n_png += 1
        print(f"phase 6: the saved PLY rendered through cli/render.py: {n_png} PNGs")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def build_kernels() -> None:
    """One nvcc per kernel source, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from seganygaussians_torch.ops.blend_cuda import BACKWARD, FORWARD

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for future in [pool.submit(k.library) for k in (FORWARD, BACKWARD)]:
            future.result()
    print(f"kernel builds (in parallel) + load: {time.perf_counter() - t0:.1f} s")
    for kernel in (FORWARD, BACKWARD):
        for ln in kernel.build_log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"ptxas [{kernel.name}]:", ln.strip())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "seganygaussians_torch")):
        print("chip_smoke: seganygaussians_torch/ not found beside this script", file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = gpu_line()
    print(card)
    t_start = time.perf_counter()
    build_kernels()

    small_errors, small_frames = phase_small(device)
    entries, err_full, full_frames, scene, capacity = phase_full(device, card, small_errors)
    phase_cli(device)
    bwd_entries, err_bwd = phase_backward(card, small_frames, full_frames)
    del small_frames, full_frames
    launches = phase_train(device, card, scene, capacity)
    for entry, c in zip(bwd_entries, (3, 32)):
        entry["launches"] = launches[c]
    entries += bwd_entries
    phase_train_cli(device, card)
    worst = max(err_full, *small_errors.values())
    print(f"max |kernel - plain| over all comparisons: forward {worst:.3g}, "
          f"backward {err_bwd:.3g}")
    print(f"whole run {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
