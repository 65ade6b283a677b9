#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's render, training and segmentation paths on
one NVIDIA GPU.

    python3 chip_smoke.py

Builds the forward-blend, backward-blend and scan-variants kernels from
``seganygaussians_torch/csrc`` (one ``nvcc`` each, started together) and runs
fourteen phases, each of which raises on failure (phases 10, 12, 13 and 14
run after phase 8, on its feature field and phase 2's scene, and before
phase 9):

1. Kernel against its plain version (``ops/blend.py``) on the same CUDA
   inputs: ~2000 Gaussians at 256×192, C ∈ {3, 4, 5, 32}, the padded counts
   C ∈ {6, 16, 24} (the instances for 8, 16 and 24) and 32×32 tiles at
   C ∈ {3, 32}, then seeded strips of tiles whose ranges sit on the
   kernel's inner edges (0..200 instances around its groups of 4, sub-chunks
   of 8 and batches of 64; thin and opaque; C ∈ {3, 32} on 16×16 and 8×8
   tiles, C ∈ {6, 16, 24} on 16×16, C ∈ {3, 32} on 32×32).  Tolerances are
   those the Pallas kernel is held to: color 1e-4, final_t 5e-5, n_contrib
   exact.
2. Full size: a seeded synthetic scene at the size of a trained Mip-NeRF 360
   scene (3,000,000 Gaussians, SH degree 3, 1297×840 views).  RGB through
   ``render.render`` over 8 orbit cameras and 32-dim features through
   ``render.render_features``, and one RGB and one C = 32 frame at 32×32
   tiles (bench.py's configuration); each instance (C = 3, 32, 6 → 8, 16,
   24 on 16×16 tiles, C = 3 and 32 on 32×32) is held against the plain
   version on 64 seeded tiles (4 of 32×32) of the first frame, times are
   taken with CUDA events, and the kernel's launch count over the renders
   must be > 0.
3. The port's ``cli/render.py`` on ``examples/synth_scene`` with a seeded
   20,000-Gaussian PLY: one non-constant PNG per camera.
4. The backward kernel against its plain version
   (``blend_cuda.blend_backward_plain``, autograd through ``ops/blend.py``):
   phase 1's whole frames and its edge strips, then 64 seeded tiles (4 of
   32×32) of each of phase 2's full-size frames, with
   seeded ``g_tiles`` and a nonzero ``g_final_t``.  Each ``d_table`` column
   within 2e-4 of its largest absolute value (the JAX package's
   Pallas-vs-XLA gradient bound), ``d_bg`` within 2e-4 of Σ |g·T|, the size
   of the terms it sums.  Kernel time at the full frame, bound, plain time
   on the subset.
5. ``train_step`` at full width: phase 2's 3M-Gaussian SH-degree-3 scene with
   the training fields (scale init through ``mean_sq_dist_to_3nn`` timed on
   its 3M points), targets rendered from a seeded perturbed copy at
   1297×840.  The loss on a fixed view must drop, parameters and Adam moments
   stay finite, the backward kernel's launches equal the steps and the
   forward's are ≥ them; then one feature gradient through
   ``render.render_features`` at each other instance of the backward kernel
   (C = 32, 6 → 8, 16, 24; C = 3 and 32 on 32×32 tiles), one launch each;
   one ``densify_and_prune``; ms/step, a stage split and peak memory.
6. The port's ``cli/train_scene.py`` on ``examples/synth_scene`` with the
   flags of ``scripts/run_synth_e2e.sh`` stage 1 (2900 iterations): test
   PSNR at each test iteration, ≥ 35 dB at the end; the saved PLY renders
   through ``cli/render.py`` to non-constant PNGs.

7. The scan micro-benchmark kernel (``csrc/scan_variants.cu``) through the
   tool's ``run``: every variant at 1000 chunks on the (256, 256) block,
   held against ``scan_variants_plain`` to 1e-4 relative; µs per chunk, the
   bound of the function's operations at the whole card's rate (the same for
   every variant that computes T_before; beside it, scaled to the SMs the
   variant's grid fills), the feedback chain's latency floor (an estimate),
   and ``torch.cumprod``'s time.
8. ``contrastive_step`` at full width: phase 2's 3M Gaussians as a
   ``FeatureState`` (32-dim features, K = 16 smoothing with dropout 0.5, 1000
   rays, the CLI's defaults) against seeded synthetic mask stacks (24 discs
   and boxes per view) for 4 orbit views at 1297×840.  ``build_smooth_map``
   timed on the 3M points; the first step's ``d_table`` held against
   ``blend_backward_plain`` on 64 tiles with the step's own cotangent (at
   unit maximum, and clipped at its 0.99 quantile); 10
   steps: ms/step, a stage split, peak memory, 10 forward and 10 backward
   launches at C = 32, a fixed-draw loss that is finite and lower at the end.
9. The contrastive CLI chain on a COPY of ``examples/synth_scene`` with phase
   6's saved model: ``cli/get_scale.py`` (48 finite positive sidecars; one
   of its RGB + depth + mask frames, C = 5 at 200×150, through the forward
   kernel against the plain version),
   ``cli/train_contrastive_feature.py`` with the flags of
   ``scripts/run_synth_e2e.sh`` stage 3 but on the kernels (the saved
   model's mean loss over the 48 training views, its feature field and
   scale gate loaded as ``cli/gui.py`` loads them, at most 0.45 of the
   untrained model's smoothed as the CLI saves it, on the very same views
   and draws, median loss of the last five logs below
   that of the first five, median ``cos_pos`` of the last five logs ≥ 0.90),
   and
   ``cli/render.py --target contrastive_feature`` (48 non-constant maps).
10. The query layer at full width on phase 8's 3M-Gaussian feature field
   over 8 orbit views at 1297×840: 10 point queries
   (``cli/prompt_segment.py:point_query``: gate, C = 32 render, prompt,
   ``segment3d``; median ms, a stage split, the clicked pixel's feature held
   against the plain blend on its tile to 1e-4); a text query
   (``text_query``: ``language.text_segment`` on 24 seeded synthetic masks a
   view, 1 % anchors, a seeded stand-in for the CLIP scores; ms in total and
   per view, the cluster count); ``lift_scores_to_3d`` over the 8 views (ms
   per view, one backward launch at C = 3 a view, view 0's accumulator term
   held against ``blend_backward_plain`` on 64 tiles within 2e-4 of its
   largest value); ``cluster_features`` (k = 32, 2 % subsample, 20
   iterations); peak memory.
11. The segmentation CLIs on phase 9's model and scene copy:
   ``cli/prompt_segment.py --point`` at the centre of view 0's largest SAM
   mask (at its scale) gives a 3D mask that is neither empty nor everything,
   whose segmented PLY renders through ``cli/render.py --target seg`` with
   an IoU ≥ 0.5 against the clicked mask; ``--text`` without CLIP weights
   raises; ``cli/get_clip_features.py`` writes sidecars through a seeded
   stand-in encoder and ``--text --simple_lift`` on them selects Gaussians
   with one backward launch a view.
12. The interactive session (``viewer/interactive.py:SagaSession``) on phase
   2's scene and phase 8's feature field and gate, orbiting at 1297×840
   (radius 2.6, fovy 0.9): median device ms of ``render_rgb``,
   ``render_feature_map`` (split into smoothing, gate and render),
   ``render_pca``, ``render_similarity`` (after a click) and
   ``render_cluster`` (after ``cluster_in_3d``) over 10 azimuths; ms per
   click, ``segment3d`` and ``roll_back``; wall ms per ``GET /render`` of the
   web GUI over loopback (PNG included); one SIBR request through
   ``NetworkGUI`` and ``render_view``; peak memory.  It raises unless the
   forward launches by instance equal the renders issued, the clicked
   pixel's feature is within 1e-4 of the plain blend on its tile,
   ``segment3d``'s mask equals ``queries.segment3d``'s on the card and,
   more than 1e-4 from the threshold, on the host (the threshold sits at
   the 99th percentile, so the count it selects is fixed), ``roll_back``
   restores ``alive`` exactly, the SIBR reply's bytes are ``render_view``'s,
   and sessions at C = 6, 16 and 24 (the first C feature columns, a seeded
   C-wide gate) are within 1e-4 of the plain blend on 64 tiles.
13. The raster plans on phase 2's scene at 1297×840, 16×16 tiles: an RGB
   (SH 3) and a C = 32 frame through ``rasterize`` with per-row footprints
   (``row_footprints``) and with the sort-free plan (``cuda_sortfree``),
   each against the default plan's frame (color and final_t 1e-4, n_contrib
   exact), median device ms of 8 orbit views and peak memory beside the
   default plan's; the instance counts with and without rows; the sort-free
   plan's order and ranges equal to the sort's on every instance; one
   gradient through each plan (one launch each); the sort-free plan's
   instances through both kernels against the plain versions on 64 seeded
   tiles.  Then C = 64: a feature frame and its gradient run as two
   launches of the C = 32 instance each, held to the plain versions on 64
   tiles (16 at a time), with kernel times and bounds.
14. The parallel layer (``parallel/``): the scene data-parallel step with
   two cameras run as two ranks in turn (``mesh.run_in_turn``) against the
   sequential mean-gradient Adam step (``xyz`` within 1e-6; coordinates
   whose gradient is within 2e-4 of its column's max of 0 may move the
   other way: the atomics' rounding decides their sign), the contrastive
   step at (data, ray) = (2, 1) and (1, 2) against the single-camera steps
   on the same draws (gradients 1e-6 + 1e-4 of their largest value), the
   tile-sharded render (2e-5) and loss gradient (1e-6) with two slabs
   against the whole frame; then a real NCCL process group of one rank and
   ten ``make_dp_train_step``s on it (median device ms).  Every step's
   kernel launches are counted.

The second-to-last line of output is a JSON object describing the kernels
(times, bound, and each instance's launches over its main-path window:
phases 2 and 12 for the forward, 5 for the backward, 13 for C = 64, with
the launches on phases 13-14's paths beside them; the script fails if one
is 0); the last is
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
# Phase 14's scene DP step: the most xyz coordinates whose gradient is within
# float32 rounding of 0 that may move the other way from the sequential step.
MAX_LEFT_OUT = 100
N_TRAIN_STEPS, N_TRAIN_VIEWS = 10, 4
# scripts/run_synth_e2e.sh stage 1, flag for flag.
SYNTH_E2E_FLAGS = [
    "--iterations", "2900", "--eval",
    "--test_iterations", "500", "1000", "1500", "2000", "2500", "2900",
    "--densify_grad_threshold", "0.001", "--save_iterations", "2900", "--disable_viewer",
]
PSNR_GATE = 35.0
TOL_SCAN = 1e-4  # relative: float32 products in another order; TF32 emulated for log_tri
N_CONTRASTIVE_STEPS, N_MASKS = 10, 24
# scripts/run_synth_e2e.sh stage 3 without ``--backend xla``: the kernels carry it.
CONTRASTIVE_E2E_FLAGS = ["--iterations", "1500", "--num_sampled_rays", "512",
                         "--raster_capacity", "32768"]
# The JAX package's XLA-backend run of the same stage (BENCH_EVIDENCE.json,
# ``contrastive``), printed beside the port's: a quality figure, not a gate.
JAX_CONTRASTIVE_TRAJECTORY = {"loss": (0.584, 0.113), "cos_pos": (0.882, 0.957)}
COS_POS_GATE = 0.90  # the JAX run ended at 0.957; the port's seeds at 0.95-0.97
# The saved model's mean loss over the untrained model's, each as the CLI
# exports it (smoothed over all K neighbours), on the same 48 training views
# and draws (``contrastive_metrics``).  Earlier figures, on an NVIDIA H100
# 80GB HBM3, 700 W limit: the trainer's in-memory state over 8 views
# 0.29-0.44 in six runs (one view's draw is a noisy loss), over 48 views
# 0.19-0.39 in five; the median logged loss over the untrained mean
# 0.20-0.56 over sixteen runs (one logged row is one view's draw).
LOSS_RATIO_GATE = 0.45
N_CLICKS = 10
N_SESSION_FRAMES, N_SESSION_CLICKS, N_WEB_REQUESTS = 10, 5, 5
SEGMENT_MARGIN = 1e-4  # host and card scores differ by float32 rounding only
QUERY_GOAL_MS = 33.0  # a point query within one frame of interactive use
IOU_GATE = 0.5  # phase 11: the segmented render against the clicked SAM mask


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


def blend_inputs(xyz, opacity, scales, rotations, colors, camera, capacity, bg, tile_size=16,
                 row_footprints=False):
    """The rasterizer's inputs to the blend, built by the same public
    functions ``ops/rasterize.py`` calls (with ``row_footprints``, the
    row-footprint plan's instances)."""
    from seganygaussians_torch.ops.binning import expand_slots, sort_instances
    from seganygaussians_torch.ops.projection import preprocess

    prep = preprocess(xyz, camera, scales=scales, rotations=rotations,
                      tile_size=tile_size, opacities=opacity, row_footprints=row_footprints)
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


def seeded_tiles(d, count, seed):
    """``count`` seeded non-empty tiles of a frame, ascending."""
    nonempty = torch.nonzero(d["tile_starts"][1:] > d["tile_starts"][:-1]).flatten().cpu()
    pick = torch.randperm(nonempty.numel(), generator=torch.Generator().manual_seed(seed))
    return nonempty[pick[:count]].sort().values


# Range lengths around the kernels' inner edges: the 4-instance groups, the
# 8-instance sub-chunks of the backward and the 64-row batches, with empty
# tiles between them.
EDGE_LENGTHS = (0, 1, 3, 4, 5, 7, 8, 9, 0, 63, 64, 65, 127, 128, 129, 0, 200)
# The strips this script runs, as (C, opaque, tile size): both widths the
# main paths use, the 8×8 tiles (two warps a block) that no path here takes,
# the padded channel counts and the 32×32 tiles (four blocks a tile).
# tests/test_torch_cuda.py runs every C.
EDGE_STRIPS = ((3, False, 16), (3, True, 16), (32, False, 16), (32, True, 16),
               (3, True, 8), (32, False, 8), (6, False, 16), (16, True, 16),
               (24, False, 16), (3, True, 32), (32, False, 32))
# Phase 1's whole 256×192 frames, as (C, seed, tile size).
SMALL_FRAMES = ((3, 1, 16), (4, 2, 16), (5, 4, 16), (32, 3, 16), (6, 5, 16), (16, 6, 16),
                (24, 7, 16), (3, 8, 32), (32, 9, 32))


def edge_case_frame(c, seed, device, lengths=EDGE_LENGTHS, opaque=False, tile_size=16):
    """A seeded one-row strip of square tiles whose instance ranges have the
    given lengths, in ``blend_inputs``' layout.  Wide Gaussians scattered over
    the strip, so every range mixes skipped and included instances; with
    ``opaque`` the opacities are high and pixels saturate after a few
    included instances, at different places of a range.  ``gauss_s`` ends
    with padding ranks (= N) past the last range, as ``sort_instances``
    leaves them."""
    rng = np.random.default_rng(seed)
    n, num_tiles = 256, len(lengths)
    sx, sy = rng.uniform(6, 50, n), rng.uniform(6, 50, n)
    rho = rng.uniform(-0.6, 0.6, n)
    det = 1.0 - rho * rho
    cols = [rng.uniform(-8, tile_size * num_tiles + 8, n), rng.uniform(-8, tile_size + 8, n),
            1 / (sx * sx * det), -rho / (sx * sy * det), 1 / (sy * sy * det),
            rng.uniform(0.5, 0.99, n) if opaque else rng.uniform(0.01, 0.12, n)]
    table = np.concatenate([np.stack(cols, 1), rng.uniform(size=(n, c))], 1).astype(np.float32)
    ranks = [np.sort(rng.choice(n, length, replace=False)) for length in lengths]
    gauss_s = np.concatenate(ranks + [np.full(5, n)]).astype(np.int64)
    tile_s = np.repeat(np.arange(num_tiles), lengths).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    table = torch.from_numpy(table).to(device)
    return dict(
        gauss_s=torch.from_numpy(gauss_s).to(device), tile_s=torch.from_numpy(tile_s).to(device),
        tile_starts=torch.from_numpy(starts).to(device), table=table,
        means2d=table[:, 0:2].contiguous(), conics=table[:, 2:5].contiguous(),
        opacities=table[:, 5].contiguous(), colors=table[:, 6:].contiguous(),
        bg=torch.linspace(0.1, 0.9, c, device=device), grid=(num_tiles, 1, tile_size),
        num_instances=int(starts[-1]),
    )


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


def work_counts(d, n_contrib) -> tuple[int, int, dict]:
    """(visited, included) (instance, pixel) pairs of this frame, and how far
    its tiles are walked.

    A pixel must evaluate each instance of its tile up to the one that ends
    its march: instance j is visited while the product of (1 − α) over the
    contributing instances before it is ≥ 1e-4.  Counted exactly, chunk by
    chunk of whole tiles.  A tile is walked as far as the pixel that visits
    the most: the third value holds that length's mean, quantiles and largest
    value over the tiles, beside the range lengths'."""
    from seganygaussians_torch.ops import blend as blend_torch

    starts = d["tile_starts"].long().cpu().tolist()
    starts_dev = d["tile_starts"].long()
    num_tiles = len(starts) - 1
    grid_x, _, ts = d["grid"]
    n = d["table"].shape[0]
    visited, t0 = 0, 0
    walked = torch.zeros(num_tiles, device=starts_dev.device)
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
            seen = (cum - log1m - base) >= log_eps
            visited += int(seen.sum())
            per_pixel = torch.zeros((t1 - t0, seen.shape[1]), device=seen.device)
            walked[t0:t1] = per_pixel.index_add_(0, tile - t0, seen.float()).amax(dim=1)
        t0 = t1
    length = (starts_dev[1:] - starts_dev[:-1]).float()
    q = torch.tensor([0.5, 0.9, 0.99], device=length.device)
    busy = length > 0
    walk = {
        "tiles": num_tiles, "busy_share": float(busy.float().mean()),
        "range_mean": float(length.mean()), "range_quantiles": torch.quantile(length, q).tolist(),
        "walked_mean": float(walked.mean()),
        "walked_mean_busy": float(walked[busy].mean()) if bool(busy.any()) else 0.0,
        "walked_quantiles": torch.quantile(walked, q).tolist(), "walked_max": float(walked.max()),
        "pixel_visited_mean": visited / (num_tiles * ts * ts),
    }
    return visited, int(n_contrib.sum()), walk


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
    """Kernel vs plain version, whole frames, C ∈ {3, 4, 5, 32} (5: RGB +
    depth + mask, the mask-scale render's instance), C ∈ {6, 16, 24} (the
    instances for 8, 16 and 24; 6 on zero-padded columns) and 32×32 tiles at
    C ∈ {3, 32}; then the edge strips."""
    from seganygaussians_torch.models import gaussians as gm
    from seganygaussians_torch.ops.camera import make_camera
    from seganygaussians_torch.ops.sh import eval_sh_color

    errors, frames = {}, {}
    for c, seed, ts in SMALL_FRAMES:
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
                         colors, cam, 1 << 18, bg, tile_size=ts)
        out = run_kernel(d)
        plain = run_plain(d, d["gauss_s"], d["tile_s"], d["tile_starts"])
        torch.cuda.synchronize()
        err = compare(out, plain)
        errors[(c, ts)] = err
        print(f"phase 1: C={c} ({ts}x{ts} tiles): {d['num_instances']} instances, max n_contrib "
              f"{int(out[2].max())}, max |kernel - plain| {err:.3g}")
        check(int(out[2].max()) > 10, "small scene too thin to test the march")
        frames[(c, ts)] = d
    edge_frames = {}
    for c, opaque, ts in EDGE_STRIPS:
        d = edge_case_frame(c, 50 + c, device, opaque=opaque, tile_size=ts)
        out = run_kernel(d)
        plain = run_plain(d, d["gauss_s"][: d["num_instances"]], d["tile_s"], d["tile_starts"])
        torch.cuda.synchronize()
        err = compare(out, plain)
        errors[(c, ts)] = max(errors.get((c, ts), 0.0), err)
        check(int(out[2].max()) > 10, "edge strip too thin to test the march")
        check(not opaque or float(out[1].min()) < 2e-4, "no pixel of the opaque strip saturated")
        edge_frames[(c, opaque, ts)] = d
    worst = {f"C={c}/{ts}x{ts}": float(f"{e:.3g}") for (c, ts), e in errors.items()}
    print(f"phase 1: edge strips (ranges of {sorted(set(EDGE_LENGTHS))} instances; C, opaque, "
          f"tile size: {list(EDGE_STRIPS)}): max |kernel - plain| {json.dumps(worst)} "
          f"with the whole frames, n_contrib exact")
    return errors, frames, edge_frames


def phase_full(device, card, small_errors):
    """3M Gaussians, SH degree 3, 1297×840, through render.render and
    render.render_features.  Returns the kernel entries (``main`` sets their
    main-path launches), the forward's launches by instance over the
    main-path windows, and what later phases reuse."""
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
        main_launches = dict(FORWARD.launches_by_instance)
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

        # --- 32×32 tiles (bench.py's configuration): one RGB frame through
        # render.render and one C=32 frame through render.render_features,
        # counted on their own.
        totals32 = [int(preprocess(p.xyz, cam, scales=scales, rotations=rots, opacities=opa,
                                   tile_size=32).tiles_touched.sum()) for cam in cams]
        config32 = RasterConfig(capacity=suggest_capacity(max(totals32)), tile_size=32)
        frames32 = {
            "RGB": lambda: R.render(cams[0], state, bg, active_sh_degree=SH_DEGREE,
                                    config=config32),
            "C=32": lambda: R.render_features(cams[0], p.xyz, opa, scales, rots, feats,
                                              config=config32),
        }
        for fn in frames32.values():  # warm-up
            fn()
        torch.cuda.synchronize()
        FORWARD.reset_counts()
        frame32_ms = {}
        for kind, fn in frames32.items():
            out32, frame32_ms[kind], _ = timed_call(fn)
            check(not out32["overflow"] and bool(torch.isfinite(out32["render"]).all()),
                  f"the 32x32 {kind} frame overflowed or is not finite")
        launches32 = dict(FORWARD.launches_by_instance)
        # ---
        check(launches32 == {"C=3,32x32": 1, "C=32,32x32": 1},
              f"the 32x32 frames' launches {launches32}")
        main_launches.update(launches32)
        print(f"phase 2: frames at 32x32 tiles, device ms: RGB through render.render "
              f"{frame32_ms['RGB']:.3f}, C=32 through render.render_features "
              f"{frame32_ms['C=32']:.3f}; capacity {config32.capacity}, launches {launches32}  "
              f"[{card}]")

        # --- each kernel instance alone at the main path's shapes, and
        # against the plain version on seeded tiles: 64 of 16×16 or 4 of
        # 32×32 (about as many (instance, pixel) pairs: the plain version's
        # (M, P, C) arrays bound what fits).
        entries, worst, frames = [], 0.0, {}
        _, _, center = cams[0].tensors(device)
        rgb = eval_sh_color(SH_DEGREE, gm.get_shs(p), p.xyz, center)
        instances = (  # name, colors, tile size, capacity
            ("blend_fwd[C=3]", rgb, 16, capacity),
            ("blend_fwd[C=32]", feats, 16, capacity),
            ("blend_fwd[C=8]", feats[:, :6], 16, capacity),  # C = 6 on zero-padded columns
            ("blend_fwd[C=16]", feats[:, :16], 16, capacity),
            ("blend_fwd[C=24]", feats[:, :24], 16, capacity),
            ("blend_fwd[C=3,32x32]", rgb, 32, config32.capacity),
            ("blend_fwd[C=32,32x32]", feats, 32, config32.capacity),
        )
        for name, colors, ts, cap in instances:
            c = colors.shape[1]
            d = blend_inputs(p.xyz, opa, scales, rots, colors.contiguous(), cams[0], cap,
                             torch.zeros(c, device=device), tile_size=ts)
            out = run_kernel(d)
            kernel_ms = float(np.median(cuda_time_ms(lambda: run_kernel(d), warmup=2, iters=10)))
            tiles = seeded_tiles(d, N_SUBSET_TILES if ts == 16 else 4, c)
            sub = subset(d, tiles)
            plain = run_plain(d, *sub)
            torch.cuda.synchronize()
            err = compare(out, plain, rows=tiles.to(device))
            worst = max(worst, err)
            # The comparison above was the plain version's warm-up.
            plain_ms = float(np.median(cuda_time_ms(lambda: run_plain(d, *sub), warmup=0, iters=3)))
            del plain
            sub_d = dict(d, gauss_s=sub[0], tile_starts=sub[2])
            sub_kernel_ms = float(np.median(cuda_time_ms(lambda: run_kernel(sub_d), warmup=1, iters=5)))
            # Frames of one tile size have the same geometry, so the same
            # pairs are visited: counted once per tile size, chunk by chunk
            # over the whole frame.
            first = frames.get((3, ts))
            if first is not None:
                check(torch.equal(d["tile_starts"], first[0]["tile_starts"]),
                      f"{name}: the tile ranges differ from the C=3 frame's")
                visited, included = first[2], int(out[2].sum())
                check(included == first[3], f"{name} includes other pairs than the C=3 frame")
            else:
                visited, included, walk = work_counts(d, out[2])
                print(f"phase 2: {ts}x{ts} tiles: per tile (quantiles at 0.5 / 0.9 / 0.99), "
                      f"instances in range and instances walked before every pixel has "
                      f"saturated: {json.dumps(walk)}")
            frames[(c, ts)] = (d, tiles, visited, included)
            bound_ms, bound_by, nbytes, ops = bound(d, visited, included)
            print(f"phase 2: {name}: C={c}, {d['num_instances']} instances, kernel "
                  f"{kernel_ms:.3f} ms (full frame), bound {bound_ms:.4f} ms by {bound_by} = "
                  f"{bound_ms / kernel_ms:.1%} of the kernel's time ({nbytes} B, {ops} ops; "
                  f"{visited} visited / {included} included pairs); {len(tiles)}-tile subset: "
                  f"kernel {sub_kernel_ms:.3f} ms, plain {plain_ms:.3f} ms (no yardstick of "
                  f"speed); max |kernel - plain| {err:.3g}  [{card}]")
            entries.append({
                "name": name,
                "route": "cuda",
                "source": "seganygaussians_torch/csrc/blend_fwd.cu",
                "replaces": "seganygaussians_tpu/ops/blend_pallas.py:252",
                "max_abs_err": max(err, small_errors.get((c, ts), 0.0)),
                "ms": kernel_ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "share_of_bound": bound_ms / kernel_ms,
                "library_ms": None,
            })
    return entries, main_launches, worst, frames, s, capacity


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


def bg_terms(g_tiles, final_t):
    """Σ |g·T| over tiles and pixels, per channel: the size of the terms that
    d_bg = Σ g·T adds up.  The sum can cancel to a small fraction of them,
    and two float32 summation orders then differ by more than a fraction of
    the sum itself, so d_bg's difference is held to this scale."""
    return torch.einsum("tpc,tp->c", g_tiles.abs(), final_t.abs())


def run_backward(d, gauss_s, tile_starts, g_tiles, g_final_t):
    """Forward kernel for the residuals, then the backward kernel: (d_table,
    d_bg, :func:`bg_terms`)."""
    from seganygaussians_torch.ops.blend_cuda import FORWARD, blend_backward

    grid_x, _, ts = d["grid"]
    tiles, final_t, _ = FORWARD(gauss_s, tile_starts, d["table"], d["bg"], grid_x, ts)
    d_table, d_bg = blend_backward(gauss_s, tile_starts, d["table"], d["bg"], tiles, final_t,
                                   g_tiles, g_final_t, grid_x, ts)
    return d_table, d_bg, bg_terms(g_tiles, final_t)


def run_backward_plain(d, gauss_s, tile_starts, g_tiles, g_final_t):
    from seganygaussians_torch.ops.blend_cuda import blend_backward_plain

    return blend_backward_plain(gauss_s, tile_starts, d["table"], d["bg"], g_tiles,
                                g_final_t, d["grid"])


def grad_errors(got, want) -> tuple[float, float]:
    """(largest |kernel − plain| over its scale, largest absolute
    difference) over the columns of d_table and d_bg, where ``got`` is
    (d_table, d_bg, :func:`bg_terms`).  A d_table column's scale is its
    largest |plain|; d_bg's is the size of the terms it sums."""
    worst_rel = worst_abs = 0.0
    for name, a, b, scale in (("d_table", got[0], want[0], want[0].abs().amax(dim=0)),
                              ("d_bg", got[1][None], want[1][None], got[2])):
        check(bool(torch.isfinite(a).all()), f"backward kernel: non-finite {name}")
        scale = scale + 1e-6
        worst_rel = max(worst_rel, float(((a - b).abs() / scale).max()))
        worst_abs = max(worst_abs, float((a - b).abs().max()))
    return worst_rel, worst_abs


def column_error(got, want) -> float:
    """Largest |got − want| of two gradients of one tensor over the largest
    |want| of its column (plus grad_errors' 1e-6)."""
    g, w = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    if w.numel() == 0:
        return 0.0
    return float(((g - w).abs() / (w.abs().amax(dim=0) + 1e-6)).max())


def compare_grads(got, want) -> float:
    """Raise unless every column of d_table is within TOL_GRAD of that
    column's largest |plain|, and d_bg within TOL_GRAD of the size of its
    terms; return the largest absolute difference."""
    rel, worst = grad_errors(got, want)
    check(rel <= TOL_GRAD, f"backward kernel differs from the plain version by {rel:.3g} of a "
          f"column's scale (tolerance {TOL_GRAD})")
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


def phase_backward(card, small_frames, edge_frames, full_frames) -> tuple[list, float]:
    """Backward kernel vs plain version: whole small frames, the edge strips,
    then 64 tiles (4 of 32×32) of the full-size frames."""
    from seganygaussians_torch.ops import blend_cuda
    from seganygaussians_torch.ops.blend_cuda import BACKWARD, FORWARD

    worst, small_err = 0.0, {}
    for (c, ts), d in small_frames.items():
        g_tiles, g_final_t = grad_inputs(d, 100 + c)
        got = run_backward(d, d["gauss_s"], d["tile_starts"], g_tiles, g_final_t)
        want = run_backward_plain(d, d["gauss_s"], d["tile_starts"], g_tiles, g_final_t)
        torch.cuda.synchronize()
        small_err[(c, ts)] = compare_grads(got, want)
        check(float(want[0][:, :6].abs().amax(dim=0).min()) > 0, "a geometry column is zero")
        print(f"phase 4: C={c} whole 256x192 frame, {ts}x{ts} tiles: max |kernel - plain| "
              f"{small_err[(c, ts)]:.3g}")
        worst = max(worst, small_err[(c, ts)])
    for (c, _, ts), d in edge_frames.items():
        g_tiles, g_final_t = grad_inputs(d, 300 + c)
        got = run_backward(d, d["gauss_s"], d["tile_starts"], g_tiles, g_final_t)
        want = run_backward_plain(d, d["gauss_s"], d["tile_starts"], g_tiles, g_final_t)
        torch.cuda.synchronize()
        small_err[(c, ts)] = max(small_err.get((c, ts), 0.0), compare_grads(got, want))
        # Both marches include the same pairs: under an all-ones color
        # cotangent a Gaussian's color gradient is its summed weight.
        ones = torch.ones_like(g_tiles)
        got = run_backward(d, d["gauss_s"], d["tile_starts"], ones, None)
        want = run_backward_plain(d, d["gauss_s"], d["tile_starts"], ones, None)
        torch.cuda.synchronize()
        check(bool(torch.equal(got[0][:, 6:] != 0, want[0][:, 6:] != 0)),
              f"C={c} edge strip: the backward kernel includes other pairs than the forward")
        worst = max(worst, small_err[(c, ts)])
    print(f"phase 4: edge strips (the {len(edge_frames)} of phase 1): within {TOL_GRAD} of each "
          f"column's max; color gradients nonzero for exactly the Gaussians the plain march included")

    entries = []
    for (c, ts), (d, tiles, visited, included) in sorted(full_frames.items()):
        grid_x = d["grid"][0]
        instance = blend_cuda.instance_name(c, ts)
        # The plain backward keeps the subset's (instances, 256, C) graph: at
        # C = 32 tens of GB.  Hand the allocator's cached blocks back first so
        # that their fragmentation does not decide whether it fits.
        torch.cuda.empty_cache()
        g_tiles, g_final_t = grad_inputs(d, 200 + c)
        sub = subset(d, tiles)
        got = run_backward(d, sub[0], sub[2], g_tiles, g_final_t)
        want = run_backward_plain(d, sub[0], sub[2], g_tiles, g_final_t)
        torch.cuda.synchronize()
        err = compare_grads(got, want)
        worst = max(worst, err)
        # The plain version's outputs may sit inside the block its graph
        # took: free them, so that the timed calls can take it again.
        del got, want
        torch.cuda.empty_cache()
        plain_ms = float(np.median(cuda_time_ms(  # warmed up by the comparison above
            lambda: run_backward_plain(d, sub[0], sub[2], g_tiles, g_final_t),
            warmup=0, iters=3)))
        # The kernel alone at the full frame, on the forward's residuals.
        res = FORWARD(d["gauss_s"], d["tile_starts"], d["table"], d["bg"], grid_x, ts)
        args = (d["gauss_s"], d["tile_starts"], d["table"], d["bg"], g_tiles, g_final_t,
                res[0], res[1], grid_x, ts)
        kernel_ms = float(np.median(cuda_time_ms(lambda: BACKWARD(*args), warmup=2, iters=10)))
        bound_ms, bound_by, nbytes, ops = bound_backward(d, visited, included)
        print(f"phase 4: blend_bwd[{instance}]: C={c}, {d['num_instances']} instances, kernel "
              f"{kernel_ms:.3f} ms (full frame), bound {bound_ms:.4f} ms by {bound_by} = "
              f"{bound_ms / kernel_ms:.1%} of the kernel's time "
              f"({nbytes} B, {ops} ops; {visited} visited / {included} included pairs); "
              f"{len(tiles)}-tile subset: plain {plain_ms:.3f} ms (no yardstick of speed); "
              f"max |kernel - plain| {err:.3g}  [{card}]")
        entries.append({
            "name": f"blend_bwd[{instance}]",
            "route": "cuda",
            "source": "seganygaussians_torch/csrc/blend_bwd.cu",
            "replaces": "seganygaussians_tpu/ops/blend_pallas.py:397",
            "max_abs_err": max(err, small_err.get((c, ts), 0.0)),
            "ms": kernel_ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "share_of_bound": bound_ms / kernel_ms,
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


class Spy:
    """Wrap a callable: CUDA events around every call, the last call's
    arguments and result kept."""

    def __init__(self, fn):
        self.fn, self.events, self.args, self.out = fn, [], None, None

    def __call__(self, *args, **kwargs):
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        self.events.append(ev)  # in order of entry: an outer call comes first
        ev[0].record()
        self.out = self.fn(*args, **kwargs)
        ev[1].record()
        self.args = args
        return self.out

    def ms(self) -> float:
        return sum(a.elapsed_time(b) for a, b in self.events)


def train_stages(state, cam, gt, bg, hyper, config, extent) -> dict[str, float]:
    """Device ms of each stage of one train_step (the split of
    ``scene_trainer.train_step``), with CUDA events between the stages and
    around the backward kernel's launch."""
    from seganygaussians_torch.models import gaussians as gm
    from seganygaussians_torch.models import optim
    from seganygaussians_torch.ops import blend_cuda, losses
    from seganygaussians_torch.train.scene_trainer import _render

    spy = Spy(blend_cuda.BACKWARD)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    blend_cuda.BACKWARD = spy
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
        blend_cuda.BACKWARD = spy.fn
    check(len(spy.events) == 1, f"{len(spy.events)} backward launches in one step")
    kernel = spy.ms()
    backward = ev[2].elapsed_time(ev[3])
    return {"forward_render": ev[0].elapsed_time(ev[1]), "loss_ssim": ev[1].elapsed_time(ev[2]),
            "backward_kernel": kernel, "autograd_rest": backward - kernel,
            "adam_stats": ev[3].elapsed_time(ev[4]), "step_total": ev[0].elapsed_time(ev[4])}


def phase_train(device, card, s, capacity) -> dict[str, int]:
    """train_step at full width on phase 2's scene, then the feature
    render's gradient at each other instance; returns the backward kernel's
    launches by instance over the main-path window."""
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
    feats = torch.randn(N_FULL, 32, generator=g, device=device)
    feat_target = torch.rand(H_FULL, W_FULL, 32, generator=g, device=device)
    p = state.params
    geometry = (p.xyz[:N_FULL], gm.get_opacity(p)[:N_FULL, 0], gm.get_scaling(p)[:N_FULL],
                gm.get_rotation(p)[:N_FULL])
    with torch.no_grad():
        total32 = int(preprocess(geometry[0], cams[0], scales=geometry[2], rotations=geometry[3],
                                 opacities=geometry[1], tile_size=32).tiles_touched.sum())
    config32 = RasterConfig(capacity=suggest_capacity(total32), tile_size=32)

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
    # The gradient of the feature render through the public entry point at
    # every other instance: C = 32 (the contrastive path's), C = 6, 16 and 24
    # (a feature_dim setting; 6 runs on the C = 8 instance), and C = 3 and
    # 32 on 32×32 tiles.
    grads = {}
    for c, cfg in ((32, config), (6, config), (16, config), (24, config), (3, config32),
                   (32, config32)):
        f = feats[:, :c].clone(memory_format=torch.contiguous_format).requires_grad_(True)
        out = R.render_features(cams[0], *geometry, f, config=cfg)
        check(not out["overflow"], f"C={c} feature render overflowed its capacity")
        ((out["render"] - feat_target[..., :c]) ** 2).mean().backward()
        grads[(c, cfg.tile_size)] = f.grad
        del out, f
    torch.cuda.synchronize()
    launches = dict(BACKWARD.launches_by_instance)
    # ---
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(bwd_rgb[3] == N_TRAIN_STEPS and sum(bwd_rgb.values()) == N_TRAIN_STEPS,
          f"backward kernel launches {bwd_rgb} over {N_TRAIN_STEPS} train steps")
    check(fwd_rgb >= N_TRAIN_STEPS, f"forward kernel launches {fwd_rgb} < {N_TRAIN_STEPS}")
    check(launches == {"C=3": N_TRAIN_STEPS, "C=32": 1, "C=8": 1, "C=16": 1, "C=24": 1,
                       "C=3,32x32": 1, "C=32,32x32": 1},
          f"backward launches by instance {launches}")
    for (c, ts), grad in grads.items():
        check(bool(torch.isfinite(grad).all()) and float(grad.abs().max()) > 0,
              f"C={c} feature gradient on {ts}x{ts} tiles")
    del grads
    for name, leaf in zip(("params", "mu", "nu"), (state.params, state.opt.mu, state.opt.nu)):
        check(all(bool(torch.isfinite(x).all()) for x in leaf), f"non-finite {name}")
    loss_after = fixed_view_loss(state, cams[0], gts[0], bg, config)
    check(loss_after < loss_before, f"fixed-view loss did not drop: {loss_before} -> "
          f"{loss_after}")
    print(f"phase 5: {N_TRAIN_STEPS} train steps at {W_FULL}x{H_FULL}, {N_FULL} Gaussians: "
          f"fixed-view loss {loss_before:.5f} -> {loss_after:.5f}; ms/step median "
          f"{float(np.median(step_ms)):.3f} (device, CUDA events; host "
          f"{float(np.median(host_ms)):.3f}); forward launches {fwd_rgb}, backward "
          f"launches {bwd_rgb}, with the feature renders' gradients by instance {launches}; "
          f"peak memory {peak_gb:.2f} GB  [{card}]")
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
    return launches


def phase_train_cli(device, card, tmp) -> None:
    """The port's trainer CLI on examples/synth_scene with the e2e flags, then
    the saved PLY through cli/render.py.  The model stays in ``tmp`` for
    phase 9."""
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


def phase_scan(device, card) -> tuple[list, float]:
    """The scan micro-benchmark kernel through the tool's ``run``, each
    variant held against the plain version."""
    from seganygaussians_torch.tools import bench_scan_variants as tool

    n_chunk = tool.N_CHUNK
    s = tool.seeded_block(device)
    # --- the main path (the tool's entry point): counts at 0 just before,
    # read just after.
    tool.SCAN.reset_counts()
    runs = {v: tool.run(v, n_chunk, device) for v in tool.VARIANTS}
    torch.cuda.synchronize()
    launches = {v: tool.SCAN.launches_of(v) for v in tool.VARIANTS}
    # ---
    library_us = {1: tool.cumprod_library_us(device, dim=1),
                  0: tool.cumprod_library_us(device, dim=0)}
    entries, worst = [], 0.0
    low, high = tool.latency_floor_us()
    for v in tool.VARIANTS:
        us, out = runs[v]
        check(launches[v] > 0, f"scan variant {v} was not launched")
        plain = tool.scan_variants_plain(s, v, n_chunk, tf32=True)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"scan variant {v}: non-finite output")
        err = float((out - plain).abs().max())
        rel = float(((out - plain).abs() / plain.abs().clamp_min(1e-30)).max())
        check(rel <= TOL_SCAN, f"scan variant {v} differs from the plain version by "
              f"{rel:.3g} relative (tolerance {TOL_SCAN})")
        worst = max(worst, rel)
        t0 = time.perf_counter()
        tool.scan_variants_plain(s, v, n_chunk, tf32=True)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        bound_us = tool.bound_us(v)
        grid_us, sms = tool.bound_us_on_grid_sms(v)
        # exp_only takes no cumulative product: no library call computes it.
        lib_us = None if v == "exp_only" else library_us[0 if v == "roll_sub" else 1]
        lib_txt = "none" if lib_us is None else f"{lib_us:.3f} us/call"
        print(f"phase 7: {v:11s} {us:8.3f} us/chunk ({tool.P}x{tool.K}, {n_chunk} chunks, "
              f"{launches[v]} launches), bound {bound_us:.4f} us by the function's operations "
              f"on the card "
              f"({grid_us:.4f} us on the {sms} of {tool.NUM_SMS} SMs its grid fills), plain {plain_ms / n_chunk * 1e3:.1f} us/chunk (no yardstick "
              f"of speed), torch.cumprod {lib_txt}; max |kernel - plain| {err:.3g} "
              f"({rel:.3g} relative)  [{card}]")
        entries.append({
            "name": f"scan_variants[{v}]",
            "route": "cuda",
            "source": "seganygaussians_torch/csrc/scan_variants.cu",
            "replaces": "tools/bench_scan_variants.py:42",
            "launches": launches[v],
            "max_abs_err": err,
            "ms": us * n_chunk / 1e3,
            "plain_ms": plain_ms,
            "bound_ms": bound_us * n_chunk / 1e3,
            "bound_by": "operations",
            "library_ms": None if lib_us is None else lib_us * n_chunk / 1e3,
            "bound_ms_on_grid_sms": grid_us * n_chunk / 1e3,
            "sms": sms,
            "latency_floor_ms_estimate": [low * n_chunk / 1e3, high * n_chunk / 1e3],
        })
    print(f"phase 7: the chunks' feedback chain sets a latency floor of {low:.4f}-{high:.4f} "
          f"us/chunk (an estimate from its instructions, not a measurement), above every "
          f"bound  [{card}]")
    if runs["log_tri"][0] >= runs["log_tri_hs"][0]:
        print("phase 7: the TF32 tensor-core product (log_tri) is no faster than the fp32 one "
              "(log_tri_hs) on this card at this size")
    return entries, worst


def synthetic_masks(seed, n_masks, width, height):
    """A seeded SAM-like stack for one view: discs and boxes of mixed size
    (radii from a third of the frame down to a fortieth) that together cover
    most of it, and a 3D scale per mask that falls with its size."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[:height, :width]
    radii = np.sort(width * rng.uniform(0.025, 0.33, n_masks))[::-1]
    masks = []
    for i, r in enumerate(radii):
        cx, cy = rng.uniform(0, width), rng.uniform(0, height)
        if i % 2:
            masks.append((np.abs(xs - cx) < r) & (np.abs(ys - cy) < 0.7 * r))
        else:
            masks.append((xs - cx) ** 2 + (ys - cy) ** 2 < r * r)
    scales = (radii / width * 4.0 * rng.uniform(0.9, 1.1, n_masks)).astype(np.float32)
    return np.stack(masks), scales


def contrastive_stages(step) -> tuple[dict[str, float], Spy]:
    """Device ms of each stage of one contrastive_step (``step`` runs one),
    from CUDA events around the functions the step calls; also returns the
    backward kernel's spy (its arguments hold the step's real cotangent)."""
    from seganygaussians_torch.models import feature_gaussians as fgm
    from seganygaussians_torch.models import optim
    from seganygaussians_torch.ops import blend_cuda
    from seganygaussians_torch.train import contrastive_trainer as ct

    places = [(fgm, "smooth_features"), (ct, "rasterize"), (torch.autograd, "grad"),
              (blend_cuda, "BACKWARD"), (optim, "adam_update")]
    spies = {name: Spy(getattr(mod, name)) for mod, name in places}
    ends = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for mod, name in places:
        setattr(mod, name, spies[name])
    try:
        ends[0].record()
        step()
        ends[1].record()
        torch.cuda.synchronize()
    finally:
        for mod, name in places:
            setattr(mod, name, spies[name].fn)
    for name, n in (("smooth_features", 1), ("rasterize", 1), ("BACKWARD", 1),
                    ("adam_update", 2)):
        check(len(spies[name].events) == n, f"{len(spies[name].events)} calls of {name} in a step")
    smooth, raster, grad = (spies[k].events[0] for k in ("smooth_features", "rasterize", "grad"))
    kernel = spies["BACKWARD"].ms()
    return {
        "draws_gt_weights": ends[0].elapsed_time(smooth[0]),
        "smoothing_gather": smooth[0].elapsed_time(smooth[1]),
        "forward_render": smooth[1].elapsed_time(raster[1]),
        "loss_on_rays": raster[1].elapsed_time(grad[0]),
        "backward_kernel": kernel,
        "autograd_rest": grad[0].elapsed_time(grad[1]) - kernel,
        "adam": grad[1].elapsed_time(ends[1]),
        "step_total": ends[0].elapsed_time(ends[1]),
    }, spies["BACKWARD"]


def step_backward_errors(args, device):
    """The backward kernel against ``blend_backward_plain`` on 64 seeded tiles
    under a training step's own cotangent (``args`` are the arguments the
    step gave the kernel): nonzero on the sampled rays' pixels, plus the
    feature-norm term everywhere, and no ``g_final_t``.

    The backward is linear in the cotangent, so it is compared at unit
    maximum: the raw one averages over R² pairs and H·W pixels, and most of it
    would sit under ``grad_errors``' 1e-6 floor.  A few hundred pixels whose
    feature vector is nearly zero carry entries thousands of times the rest
    (the normalisation's 1/|x|) and alone set each column's maximum, so the
    comparison is made a second time with the cotangent clipped at the 0.99
    quantile of its nonzero pixels, where the ordinary pixels decide.
    Returns ((rel, abs) at unit maximum, (rel, abs) clipped, a description)."""
    from seganygaussians_torch.ops.blend_cuda import BACKWARD, FORWARD, blend_backward_plain

    gauss_s, tile_starts, table, bg, g_tiles, g_final_t, _, _, grid_x, ts = args
    check(table.shape[1] == 38, f"the step's blend table has {table.shape[1]} columns")
    check(float(g_final_t.abs().max()) == 0, "the step has a final_t cotangent")
    per_pixel = g_tiles.abs().amax(dim=2)
    lit_pixels = per_pixel[per_pixel > 0]
    check(lit_pixels.numel() > 0, "the step's cotangent is all zero")
    scale = lit_pixels.max()
    clip = torch.quantile(lit_pixels, 0.99)
    starts = tile_starts.long()
    counts = starts[1:] - starts[:-1]
    grid = (grid_x, counts.shape[0] // grid_x, ts)
    tile_s = torch.repeat_interleave(torch.arange(counts.shape[0], device=device), counts)
    d = dict(gauss_s=gauss_s[: int(starts[-1])], tile_s=tile_s, tile_starts=tile_starts)
    lit = torch.nonzero((per_pixel.amax(dim=1) > 0) & (counts > 0)).flatten().cpu()
    pick = torch.randperm(lit.numel(), generator=torch.Generator().manual_seed(8))
    tiles = lit[pick[:N_SUBSET_TILES]].sort().values
    rows = tiles.to(device)
    sub = subset(d, tiles)
    res = FORWARD(sub[0], sub[2], table, bg, grid_x, ts)

    def errors(g):
        torch.cuda.empty_cache()  # the plain backward's graph needs contiguous tens of GB
        got = (BACKWARD(sub[0], sub[2], table, bg, g, torch.zeros_like(g_final_t), res[0],
                        res[1], grid_x, ts),
               torch.einsum("tpc,tp->c", g[rows], res[1][rows]),
               bg_terms(g[rows], res[1][rows]))
        g_sub = torch.zeros_like(g)
        g_sub[rows] = g[rows]
        want = blend_backward_plain(sub[0], sub[2], table, bg, g_sub, None, grid)
        torch.cuda.synchronize()
        return grad_errors(got, want), float(want[0].abs().max())

    unit, largest = errors(g_tiles / scale)
    clipped, largest_clipped = errors(g_tiles.clamp(-clip, clip) / clip)
    info = (f"scaled to unit maximum from {float(scale):.3g}; {lit_pixels.numel()} nonzero "
            f"pixels, {int((per_pixel > 1e-3 * scale).sum())} above a thousandth of the largest; "
            f"largest |d_table| {largest:.3g}; clipped at the 0.99 quantile {float(clip):.3g}: "
            f"largest |d_table| {largest_clipped:.3g}")
    return unit, clipped, info


def phase_contrastive(device, card, s, capacity) -> tuple[dict[str, int], object, object]:
    """contrastive_step at full width on phase 2's scene; returns the forward
    and backward kernels' C = 32 launches over the main-path window, and the
    trained feature state and scale gate."""
    from seganygaussians_torch.models import feature_gaussians as fgm
    from seganygaussians_torch.models import optim
    from seganygaussians_torch.ops.blend_cuda import BACKWARD, FORWARD
    from seganygaussians_torch.ops.quantile import fit_quantile_transform
    from seganygaussians_torch.ops.rasterize import RasterConfig
    from seganygaussians_torch.seg.scale_gate import init_scale_gate
    from seganygaussians_torch.train import contrastive_trainer as ct

    hyper = ct.ContrastiveHyper()  # the CLI's defaults: 1000 rays, K = 16, dropout 0.5
    xyz = s["xyz"].contiguous()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    smooth_map = fgm.build_smooth_map(xyz, hyper.smooth_k)
    torch.cuda.synchronize()
    knn_s = time.perf_counter() - t0
    check(tuple(smooth_map.shape) == (N_FULL, hyper.smooth_k), "smooth map shape")
    check(int(smooth_map.min()) >= 0 and int(smooth_map.max()) < N_FULL, "smooth map range")
    fallback = float((smooth_map[:, 1:] == smooth_map[:, :1]).any(dim=1).float().mean())
    print(f"phase 8: build_smooth_map (K={hyper.smooth_k}) on {N_FULL} points: {knn_s:.2f} s, "
          f"{fallback:.2%} of rows with a self fallback, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB  [{card}]")
    check(fallback < 0.01, "the neighbour map fell back to self on ≥ 1 % of the points")

    g = torch.Generator(device=device).manual_seed(23)
    feats = torch.randn(N_FULL, 32, generator=g, device=device) * 1e-2
    state = fgm.FeatureState(
        geom=fgm.FrozenGeometry(xyz=xyz, scaling=s["scaling"], rotation=s["rotation"],
                                opacity=s["opacity"],
                                alive=torch.ones(N_FULL, dtype=torch.bool, device=device)),
        point_features=feats, smooth_map=smooth_map,
        opt=optim.adam_init(fgm.FeatureParams(feats)),
    )
    cams = orbit_cameras(N_TRAIN_VIEWS, W_FULL, H_FULL)
    stacks = [synthetic_masks(300 + i, N_MASKS, W_FULL, H_FULL) for i in range(N_TRAIN_VIEWS)]
    bundles = [ct.build_mask_bundle(m, sc, N_MASKS, device=device) for m, sc in stacks]
    covered = float(np.mean([m.any(0).mean() for m, _ in stacks]))
    all_scales = np.concatenate([sc for _, sc in stacks])
    consts = ct.ContrastiveConsts(
        upper_bound_scale=torch.tensor(float(all_scales.max()), device=device),
        qt=fit_quantile_transform(torch.from_numpy(all_scales).to(device)),
    )
    gate = init_scale_gate(torch.Generator().manual_seed(23), 32, device=device)
    gate_opt = optim.adam_init(gate)
    config = RasterConfig(capacity=capacity)
    print(f"phase 8: synthetic masks: {N_MASKS} per view over {N_TRAIN_VIEWS} views, covering "
          f"{covered:.0%} of the frame; scales {all_scales.min():.3f}..{all_scales.max():.3f}")

    fixed_draws = ct.draw_step(torch.Generator(device=device).manual_seed(99), bundles[0],
                               hyper, hyper.smooth_k)

    def fixed_loss(state, gate) -> float:
        with torch.no_grad():
            q_scales, gt = ct._sample_scales_and_gt(fixed_draws, bundles[0], consts)
            ppw = ct._pixel_weights(bundles[0], fixed_draws.ray_idx)
            loss, aux = ct.contrastive_loss(state.point_features, gate, state, cams[0], consts,
                                            fixed_draws, q_scales, gt, ppw, hyper, config)
        check(not aux["overflow"], "fixed-draw render overflowed")
        return float(loss)

    loss_before = fixed_loss(state, gate)
    check(math.isfinite(loss_before), "fixed-draw loss not finite")

    def step(i, state, gate, gate_opt):
        return ct.contrastive_step(state, gate, gate_opt, cams[i], bundles[i], consts, hyper,
                                   config, generator=g)

    # Two steps outside the counted window, both discarded: a warm-up
    # (allocator, first launches), then an instrumented one for the stage
    # split and for the backward kernel's d_table against the plain version
    # on 64 tiles, with the step's own cotangent (nonzero on the sampled
    # rays' pixels plus the feature-norm term everywhere; g_final_t absent).
    step(1, state, gate, gate_opt)
    holder = {}
    stages, spy = contrastive_stages(
        lambda: holder.update(out=step(1, state, gate, gate_opt)))
    warm_state, warm_gate, warm_gate_opt, aux = holder.pop("out")
    check(not aux["overflow"], "instrumented step overflowed")
    (rel, err), (rel_clip, err_clip), info = step_backward_errors(spy.args, device)
    print(f"phase 8: a step's d_table vs blend_backward_plain on {N_SUBSET_TILES} tiles with the "
          f"step's own cotangent ({info}): max |kernel - plain| {err:.3g}, {rel:.3g} of a "
          f"column's max; clipped: {err_clip:.3g}, {rel_clip:.3g} of a column's max")
    for what, r in (("", rel), (" clipped at its 0.99 quantile", rel_clip)):
        check(r <= TOL_GRAD, f"backward kernel under the step's cotangent{what} differs from "
              f"the plain version by {r:.3g} of a column's max (tolerance {TOL_GRAD})")
    del spy, warm_state, warm_gate, warm_gate_opt

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # --- the main path: counts at 0 just before, read just after.
    FORWARD.reset_counts()
    BACKWARD.reset_counts()
    step_ms, host_ms, losses = [], [], []
    for it in range(N_CONTRASTIVE_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        start.record()
        state, gate, gate_opt, aux = step(it % N_TRAIN_VIEWS, state, gate, gate_opt)
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - h0) * 1e3)
        step_ms.append(start.elapsed_time(end))
        check(not aux["overflow"], f"contrastive step {it + 1} overflowed its capacity")
        losses.append(float(aux["loss"]))
        check(math.isfinite(losses[-1]), f"contrastive step {it + 1}: loss {losses[-1]}")
    fwd, bwd = dict(FORWARD.launches_by_channels), dict(BACKWARD.launches_by_channels)
    # ---
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n = N_CONTRASTIVE_STEPS
    check(fwd[32] == n and sum(fwd.values()) == n, f"forward launches {fwd} over {n} steps")
    check(bwd[32] == n and sum(bwd.values()) == n, f"backward launches {bwd} over {n} steps")
    for name, x in (("features", state.point_features), ("mu", state.opt.mu.point_features),
                    ("nu", state.opt.nu.point_features), ("gate.w", gate.w), ("gate.b", gate.b)):
        check(bool(torch.isfinite(x).all()), f"non-finite {name}")
    loss_after = fixed_loss(state, gate)
    check(loss_after < loss_before, f"fixed-draw loss did not drop: {loss_before} -> {loss_after}")
    print(f"phase 8: {n} contrastive steps at {W_FULL}x{H_FULL}, {N_FULL} Gaussians, "
          f"{hyper.num_sampled_rays} rays: fixed-draw loss {loss_before:.5f} -> {loss_after:.5f} "
          f"(per-step losses {losses[0]:.4f} .. {losses[-1]:.4f}); ms/step median "
          f"{float(np.median(step_ms)):.3f} (device, CUDA events; host "
          f"{float(np.median(host_ms)):.3f}); forward launches {fwd}, backward launches {bwd}; "
          f"rfn {float(aux['rfn']):.4f}, cos_pos {float(aux['cosine_pos']):.4f}, cos_neg "
          f"{float(aux['cosine_neg']):.4f}; peak memory {peak_gb:.2f} GB  [{card}]")
    print(f"phase 8: contrastive-step stages (one instrumented step), device ms: "
          f"{json.dumps({k: round(v, 3) for k, v in stages.items()})}  [{card}]")
    return {"fwd": fwd[32], "bwd": bwd[32]}, state, gate


def contrastive_metrics(device, src, model_dir, num_rays, capacity, trained=False) -> dict:
    """Mean loss and cos_pos over every training view of the contrastive
    CLI's model as the CLI exports it: the ``aux`` of one
    ``contrastive_step`` per view, each taken from the same state.  The
    views, masks and draws are the same on every call (a fresh trainer
    seeded as the CLI's, the same calls in the same order).  The state is
    the one the CLI starts from (the same scene, seeds and hyper-parameters)
    with its features smoothed over all K neighbours, as
    ``Scene.save_feature`` writes them, or, with ``trained``, the one it
    saved: the feature field and scale gate of the last feature iteration,
    loaded as ``cli/gui.py`` loads them.  Both are already smoothed, so the
    steps smooth no further (a second smoothing averages over neighbours of
    neighbours: the saved model's ratio was 0.56 that way)."""
    from seganygaussians_torch.models import optim
    from seganygaussians_torch.models import feature_gaussians as fgm
    from seganygaussians_torch.models.feature_gaussians import FeatureParams
    from seganygaussians_torch.ops.rasterize import RasterConfig
    from seganygaussians_torch.scene import ModelConfig, Scene
    from seganygaussians_torch.seg.scale_gate import init_scale_gate, load_scale_gate
    from seganygaussians_torch.train import contrastive_trainer as ct

    cfg = ModelConfig(source_path=src, model_path=model_dir, need_masks=True)
    scene = Scene(cfg, need_scene=False, need_features_model=True, load_iteration=-1,
                  target="contrastive_feature", mode="eval" if trained else "train",
                  device=device)
    state = scene.feature_gaussians
    if trained:
        gate = load_scale_gate(os.path.join(model_dir, "point_cloud",
                                            f"iteration_{scene.feature_loaded_iter}",
                                            "scale_gate.pt"), device=device)
    else:
        with torch.no_grad():
            state = state._replace(point_features=fgm.smoothed_point_features(state))
        gate = init_scale_gate(torch.Generator().manual_seed(0), 32, device=device)
    state = state._replace(opt=optim.adam_init(FeatureParams(state.point_features)))
    t = ct.ContrastiveTrainer(
        feat_state=state,
        gate_params=gate,
        cameras=scene.get_train_cameras(),
        hyper=ct.ContrastiveHyper(num_sampled_rays=num_rays, smooth_type="none"),
        config=RasterConfig(capacity=capacity),
    )
    rows = []
    for idx in range(len(t.cameras)):
        bundle, cam = t._prep(idx)
        *_, aux = ct.contrastive_step(t.feat_state, t.gate_params, t.gate_opt, cam, bundle,
                                      t.consts, t.hyper, t.config, generator=t.generator)
        rows.append((float(aux["loss"]), float(aux["cosine_pos"])))
    return {"loss": float(np.mean([r[0] for r in rows])),
            "cos_pos": float(np.mean([r[1] for r in rows])), "views": len(rows)}


def depth_frame_entry(device, card, src, model_dir, capacity, launches) -> dict:
    """The forward kernel against the plain version on one frame of
    ``cli/get_scale.py``'s render: the saved scene model, the first training
    view at 200×150, SH degree 0 RGB + depth + mask (C = 5), zero background,
    as ``preprocess.compute_mask_scales`` renders it.  Returns the ``kernels``
    entry of this instance."""
    from seganygaussians_torch.models import gaussians as gm
    from seganygaussians_torch.ops.projection import preprocess
    from seganygaussians_torch.ops.sh import eval_sh_color
    from seganygaussians_torch.scene import ModelConfig, Scene

    cfg = ModelConfig(source_path=src, model_path=model_dir, need_masks=True)
    scene = Scene(cfg, load_iteration=-1, mode="train", target="scene", shuffle=False,
                  device=device)
    state, cam = scene.gaussians, scene.get_train_cameras()[0].params
    with torch.no_grad():
        live = state.alive
        p = gm.GaussianParams(*(x[live] for x in state.params))
        opa, scales, rots = gm.get_opacity(p)[:, 0], gm.get_scaling(p), gm.get_rotation(p)
        _, _, center = cam.tensors(device)
        depths = preprocess(p.xyz, cam, scales=scales, rotations=rots, opacities=opa).depths
        colors = torch.cat([eval_sh_color(0, gm.get_shs(p), p.xyz, center), depths[:, None],
                            state.seg_mask[live][:, None]], dim=1)
        check(colors.shape[1] == 5, f"the depth render has {colors.shape[1]} channels")
        d = blend_inputs(p.xyz, opa, scales, rots, colors, cam, capacity,
                         torch.zeros(5, device=device))
        out = run_kernel(d)
        plain = run_plain(d, d["gauss_s"], d["tile_s"], d["tile_starts"])
        torch.cuda.synchronize()
        err = compare(out, plain)
        check(int(out[2].max()) > 0 and float(plain.tiles[..., 3].max()) > 0,
              "the depth frame is empty")
        kernel_ms = float(np.median(cuda_time_ms(lambda: run_kernel(d), warmup=2, iters=10)))
        plain_ms = float(np.median(cuda_time_ms(
            lambda: run_plain(d, d["gauss_s"], d["tile_s"], d["tile_starts"]), warmup=1, iters=3)))
        visited, included, _ = work_counts(d, out[2])
        bound_ms, bound_by, nbytes, ops = bound(d, visited, included)
    print(f"phase 9: blend_fwd[C=5] on a get_scale frame ({cam.width}x{cam.height}, "
          f"{p.xyz.shape[0]} Gaussians, {d['num_instances']} instances, largest depth "
          f"{float(plain.tiles[..., 3].max()):.3f}): kernel {kernel_ms:.4f} ms, bound "
          f"{bound_ms:.5f} ms by {bound_by} = {bound_ms / kernel_ms:.1%} of the kernel's time "
          f"({nbytes} B, {ops} ops), plain {plain_ms:.3f} ms "
          f"(whole frame; no yardstick of speed); max |kernel - plain| {err:.3g}, n_contrib "
          f"exact  [{card}]")
    return {
        "name": "blend_fwd[C=5]",
        "route": "cuda",
        "source": "seganygaussians_torch/csrc/blend_fwd.cu",
        "replaces": "seganygaussians_tpu/ops/blend_pallas.py:252",
        "launches": launches,
        "max_abs_err": err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "share_of_bound": bound_ms / kernel_ms,
        "library_ms": None,
    }


def phase_contrastive_cli(device, card, model_dir) -> tuple[dict[str, int], dict]:
    """get_scale → train_contrastive_feature → render --target
    contrastive_feature, on a copy of examples/synth_scene (get_scale writes
    its sidecars into the source directory) with phase 6's saved model."""
    from seganygaussians_torch.cli import get_scale, render, train_contrastive_feature
    from seganygaussians_torch.ops.blend_cuda import BACKWARD, FORWARD

    src = os.path.join(model_dir, "scene_copy")
    shutil.copytree(os.path.join(ROOT, "examples", "synth_scene"), src)
    committed = os.path.join(src, "mask_scales_committed")
    os.rename(os.path.join(src, "mask_scales"), committed)
    common = ["-s", src, "-m", model_dir, "--device", str(device)]

    FORWARD.reset_counts()
    BACKWARD.reset_counts()
    t0 = time.perf_counter()
    check(get_scale.main(common + ["--raster_capacity", "32768"]) == 0, "cli/get_scale.py failed")
    torch.cuda.synchronize()
    scale_s = time.perf_counter() - t0
    names = sorted(os.listdir(os.path.join(src, "mask_scales")))
    check(names == sorted(os.listdir(committed)) and len(names) == 48,
          f"{len(names)} mask-scale sidecars")
    rel = []
    for name in names:
        new = torch.load(os.path.join(src, "mask_scales", name), weights_only=False)
        old = torch.load(os.path.join(committed, name), weights_only=False)
        check(new.shape == old.shape and bool(torch.isfinite(new).all())
              and float(new.min()) > 0, f"mask scales of {name}: {new}")
        rel.append(((new - old).abs() / old).numpy())
    depth_launches = FORWARD.launches_by_channels[5]
    check(depth_launches == 48, f"get_scale launched the C=5 kernel {depth_launches} times")
    print(f"phase 9: cli/get_scale.py wrote {len(names)} sidecars in {scale_s:.1f} s "
          f"({depth_launches} C=5 launches); median relative difference to the committed "
          f"sidecars {float(np.median(np.concatenate(rel))):.3f} (another trained model: "
          f"not a gate)  [{card}]")
    depth_entry = depth_frame_entry(device, card, src, model_dir, 32768, depth_launches)

    flags = CONTRASTIVE_E2E_FLAGS
    iterations = int(flags[flags.index("--iterations") + 1])
    eval_args = (device, src, model_dir, int(flags[flags.index("--num_sampled_rays") + 1]),
                 int(flags[flags.index("--raster_capacity") + 1]))
    untrained = contrastive_metrics(*eval_args)
    FORWARD.reset_counts()
    BACKWARD.reset_counts()
    t0 = time.perf_counter()
    check(train_contrastive_feature.main(common + flags) == 0,
          "cli/train_contrastive_feature.py failed")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fwd": FORWARD.launches_by_channels[32],
                "bwd": BACKWARD.launches_by_channels[32]}
    # The saved model on the untrained figure's views and draws.
    trained = contrastive_metrics(*eval_args, trained=True)
    records = [json.loads(line) for line in open(os.path.join(model_dir, "metrics.jsonl"))]
    logs = [r for r in records if "contrastive/loss" in r]
    check(len(logs) == iterations // 100, f"{len(logs)} contrastive log rows")
    print("phase 9: iteration: loss / cos_pos / cos_neg / rfn at each log: " + "; ".join(
        f"{r['iter']}: {r['contrastive/loss']:.3f} / {r['contrastive/cos_pos']:.3f} / "
        f"{r['contrastive/cos_neg']:.3f} / {r['contrastive/rfn']:.3f}" for r in logs))
    first, last = logs[0], logs[-1]
    median_loss = float(np.median([r["contrastive/loss"] for r in logs]))
    early_loss = float(np.median([r["contrastive/loss"] for r in logs[:5]]))
    late_loss = float(np.median([r["contrastive/loss"] for r in logs[-5:]]))
    late_cos_pos = float(np.median([r["contrastive/cos_pos"] for r in logs[-5:]]))
    jax_ref = JAX_CONTRASTIVE_TRAJECTORY
    ratio = trained["loss"] / untrained["loss"]
    print(f"phase 9: {iterations} iterations in {wall:.1f} s ({wall / iterations * 1e3:.2f} "
          f"ms/iteration wall, set-up and save included), C=32 launches {launches}; on the same "
          f"{untrained['views']} views and draws (means): untrained loss {untrained['loss']:.3f} and cos_pos "
          f"{untrained['cos_pos']:.3f}, trained loss {trained['loss']:.3f} ({ratio:.3f} of the "
          f"untrained) and cos_pos {trained['cos_pos']:.3f}; "
          f"median logged loss {median_loss:.3f} ({median_loss / untrained['loss']:.3f} "
          f"of the untrained), median loss of the first 5 logs {early_loss:.3f} and of the "
          f"last 5 {late_loss:.3f}, median cos_pos of the last 5 logs {late_cos_pos:.3f}; first -> last log: loss {first['contrastive/loss']:.3f} -> "
          f"{last['contrastive/loss']:.3f}, cos_pos {first['contrastive/cos_pos']:.3f} -> "
          f"{last['contrastive/cos_pos']:.3f} (the JAX package's XLA-backend run, first -> "
          f"last log: loss {jax_ref['loss'][0]} -> {jax_ref['loss'][1]}, cos_pos "
          f"{jax_ref['cos_pos'][0]} -> {jax_ref['cos_pos'][1]})  [{card}]")
    check(launches["fwd"] == iterations and launches["bwd"] == iterations,
          f"C=32 launches {launches} over {iterations} iterations")
    check(all(math.isfinite(r["contrastive/loss"]) for r in logs), "non-finite logged loss")
    # One logged row is one view's draw.  Over four seeds on an H100 (80GB
    # HBM3, 700 W limit) single rows ranged from -0.74 to 1.78 in loss and +-0.02 in cos_pos, and the
    # first log, at iteration 100, is already past the steep part (cos_pos
    # 0.87-0.94 against 0.13 untrained): a first-log-against-last-log
    # comparison is a coin toss.  So the trained model's loss is held against
    # the untrained model's on the very same views and draws, and the logged
    # loss must still fall from the first five logs to the last five
    # (medians); cos_pos is held to a level, like PSNR.
    check(ratio <= LOSS_RATIO_GATE,
          f"trained loss {trained['loss']} is above {LOSS_RATIO_GATE} of the untrained "
          f"{untrained['loss']} on the same views and draws")
    check(late_loss < early_loss, f"median loss of the last 5 logs {late_loss} is not below "
          f"that of the first 5 {early_loss}")
    check(late_cos_pos >= COS_POS_GATE and late_cos_pos > untrained["cos_pos"],
          f"median cos_pos of the last 5 logs {late_cos_pos} < {COS_POS_GATE} "
          f"(untrained {untrained['cos_pos']})")
    out = os.path.join(model_dir, "point_cloud", f"iteration_{iterations}")
    for name in ("contrastive_feature_point_cloud.ply", "scale_gate.pt"):
        check(os.path.exists(os.path.join(out, name)), f"{name} not written")

    check(render.main(common + ["--target", "contrastive_feature", "--raster_capacity",
                                "32768"]) == 0, "cli/render.py --target contrastive_feature failed")
    (ours,) = os.listdir(os.path.join(model_dir, "contrastive_feature"))
    renders = os.path.join(model_dir, "contrastive_feature", ours, "train", "renders")
    maps = sorted(os.listdir(renders))
    check(len(maps) == 48, f"{len(maps)} feature maps for 48 views")
    for name in maps:
        fmap = np.load(os.path.join(renders, name))
        check(fmap.shape == (150, 200, 32), f"{name}: shape {fmap.shape}")
        check(bool(np.isfinite(fmap).all()) and float(fmap.std()) > 1e-3, f"{name} is constant")
    print(f"phase 9: cli/render.py --target contrastive_feature wrote {len(maps)} maps of "
          f"shape (150, 200, 32)")
    return launches, depth_entry


# ---------------------------------------------------------------------------
# Phases 10-11: the segmentation and query layer
# ---------------------------------------------------------------------------


class QueryView:
    """A view as the query layer reads it: the camera and its SAM sidecars."""

    def __init__(self, params, sam_masks, mask_scales, clip_features):
        self.params, self.sam_masks = params, sam_masks
        self.mask_scales, self.clip_features = mask_scales, clip_features


class StandInClip:
    """A seeded stand-in for the CLIP towers (no weights exist offline): a
    fixed pseudo-embedding per prompt string, and per image crop its mean
    color spread over the embedding."""

    dim = 64

    def encode_text(self, prompts):
        import hashlib

        return np.asarray([np.random.default_rng(int.from_bytes(
            hashlib.sha256(p.encode()).digest()[:4], "little")).normal(size=self.dim)
            for p in prompts], np.float32)

    def encode_image(self, images):
        return np.asarray([np.resize(np.asarray(im, np.float32).mean(axis=(0, 1)) / 255.0 + 0.1,
                                     self.dim) for im in images], np.float32)


def to_tiles(image, grid_x, grid_y, ts):
    """(H, W) image → (T, ts²) tile layout (``tiles_to_image``'s inverse),
    zero past the frame's edge."""
    h, w = image.shape
    padded = torch.zeros((grid_y * ts, grid_x * ts), device=image.device)
    padded[:h, :w] = image
    return padded.reshape(grid_y, ts, grid_x, ts).permute(0, 2, 1, 3).reshape(-1, ts * ts)


def point_stages(query) -> tuple[dict[str, float], torch.Tensor]:
    """Device ms of each stage of one point query (``query`` runs one): the
    gate, the C = 32 feature render, the prompt and ``segment3d``, from CUDA
    events around the functions ``point_query`` calls; also the rendered
    feature map."""
    from seganygaussians_torch.cli import prompt_segment as ps
    from seganygaussians_torch.seg import queries

    places = [(ps, "render_feature_map"), (queries, "segment3d")]
    spies = {name: Spy(getattr(mod, name)) for mod, name in places}
    ends = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for mod, name in places:
        setattr(mod, name, spies[name])
    try:
        ends[0].record()
        query()
        ends[1].record()
        torch.cuda.synchronize()
    finally:
        for mod, name in places:
            setattr(mod, name, spies[name].fn)
    render, seg = spies["render_feature_map"].events[0], spies["segment3d"].events[0]
    return {
        "gate_features": ends[0].elapsed_time(render[0]),
        "feature_render": render[0].elapsed_time(render[1]),
        "prompt": render[1].elapsed_time(seg[0]),
        "segment3d": seg[0].elapsed_time(seg[1]),
        "query_total": ends[0].elapsed_time(ends[1]),
    }, spies["render_feature_map"].out


def timed_call(fn):
    """(result, device ms from CUDA events, host ms) of one call."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end), (time.perf_counter() - h0) * 1e3


def phase_queries(device, card, fs, gate, s, capacity) -> dict:
    """The query layer at full width on phase 8's feature field: point
    queries, a text query, the score-map lift and the clustering."""
    from seganygaussians_torch.cli import prompt_segment as ps
    from seganygaussians_torch.models import feature_gaussians as fgm
    from seganygaussians_torch.models import gaussians as gm
    from seganygaussians_torch.ops.blend_cuda import BACKWARD, FORWARD
    from seganygaussians_torch.ops.rasterize import RasterConfig
    from seganygaussians_torch.seg import clip_text, clustering, queries

    config = RasterConfig(capacity=capacity)
    cams = orbit_cameras(N_CAMS, W_FULL, H_FULL)
    geom, alive = fs.geom, fs.geom.alive
    rng = np.random.default_rng(31)
    # Clicks inside the ball's image, where the frame is covered.
    clicks = [(int(W_FULL * rng.uniform(0.4, 0.6)), int(H_FULL * rng.uniform(0.4, 0.6)))
              for _ in range(N_CLICKS)]
    scale = 0.5
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def point(i):
        return ps.point_query(fs, gate, cams[i % N_CAMS], clicks[i], scale, 0.75, alive, config)

    with torch.no_grad():
        point(0)  # warm-up outside the counted window
        # --- the main path: counts at 0 just before, read just after.
        FORWARD.reset_counts()
        BACKWARD.reset_counts()
        point_ms, point_host, selected = [], [], []
        for i in range(N_CLICKS):
            mask, ms, host = timed_call(lambda: point(i))
            point_ms.append(ms)
            point_host.append(host)
            check(tuple(mask.shape) == (N_FULL,) and mask.dtype == torch.bool,
                  f"point query mask {tuple(mask.shape)} {mask.dtype}")
            selected.append(int(mask.sum()))
        point_fwd, point_bwd = dict(FORWARD.launches_by_channels), BACKWARD.launches
        # ---
        check(point_fwd[32] == N_CLICKS and sum(point_fwd.values()) == N_CLICKS,
              f"forward launches {point_fwd} over {N_CLICKS} point queries")
        check(point_bwd == 0, f"{point_bwd} backward launches in the point queries")
        stages, fmap = point_stages(lambda: point(0))
        # The clicked pixel's feature from the kernel against the plain blend
        # on that pixel's tile.
        x, y = clicks[0]
        d = blend_inputs(geom.xyz, fgm.get_opacity(geom)[:, 0], fgm.get_scaling(geom),
                         fgm.get_rotation(geom), queries.gate_features(fs.point_features, gate,
                                                                       scale),
                         cams[0], capacity, torch.zeros(32, device=device))
        grid_x, _, ts = d["grid"]
        tile = (y // ts) * grid_x + x // ts
        plain = run_plain(d, *subset(d, torch.tensor([tile])))
        pixel_err = float((fmap[y, x] - plain.tiles[tile, (y % ts) * ts + x % ts]).abs().max())
        check(pixel_err <= TOL_COLOR, f"clicked pixel's feature differs from the plain blend by "
              f"{pixel_err} (tolerance {TOL_COLOR})")
        check(float(plain.final_t[tile, (y % ts) * ts + x % ts]) < 0.5, "the click hit background")
        del d, plain
        median_point = float(np.median(point_ms))
        print(f"phase 10: point query (gate, C=32 render, prompt, segment3d) at {W_FULL}x{H_FULL}, "
              f"{N_FULL} Gaussians: median {median_point:.3f} ms over {N_CLICKS} clicks (device, "
              f"CUDA events; host {float(np.median(point_host)):.3f}), "
              f"{'within' if median_point <= QUERY_GOAL_MS else 'over'} the {QUERY_GOAL_MS:g} ms of "
              f"interactive use; selected {min(selected)}..{max(selected)} Gaussians; forward "
              f"launches {point_fwd}; clicked pixel's feature vs the plain blend on its tile: max "
              f"|kernel - plain| {pixel_err:.3g}  [{card}]")
        print(f"phase 10: point-query stages (one instrumented query), device ms: "
              f"{json.dumps({k: round(v, 3) for k, v in stages.items()})}  [{card}]")

        # Text query: the language flow on seeded synthetic masks, with a
        # seeded stand-in for the CLIP scores.
        views = []
        for i, cam in enumerate(cams):
            masks, mask_scales = synthetic_masks(400 + i, N_MASKS, W_FULL, H_FULL)
            clip = np.random.default_rng(500 + i).normal(size=(N_MASKS, 512)).astype(np.float32)
            views.append(QueryView(cam, masks, mask_scales, clip))
        direction = np.random.default_rng(600).normal(size=512).astype(np.float32)

        def text_scores(embeds):
            """Stand-in relevancy in (0, 1); CLIP itself is not timed."""
            z = np.asarray(embeds, np.float32) @ direction / np.sqrt(512.0)
            return (1.0 / (1.0 + np.exp(-3.0 * z))).astype(np.float32)

        text_gen = torch.Generator(device=device).manual_seed(32)
        # --- the main path: counts at 0 just before, read just after.
        FORWARD.reset_counts()
        BACKWARD.reset_counts()
        res, text_ms, text_host = timed_call(lambda: ps.text_query(
            fs, gate, views, text_scores, text_gen, 0.85, alive, config))
        text_fwd = dict(FORWARD.launches_by_channels)
        # ---
        check(text_fwd[32] == N_CAMS and sum(text_fwd.values()) == N_CAMS,
              f"forward launches {text_fwd} over a text query of {N_CAMS} views")
        check(tuple(res.mask3d.shape) == (N_FULL,), f"text mask shape {tuple(res.mask3d.shape)}")
        check(len(res.labels) == N_CAMS * N_MASKS and np.isfinite(res.scores).all(),
              "text query labels or scores")
        n_clusters = len(set(res.labels[res.labels >= 0].tolist()))
        print(f"phase 10: text query (language.text_segment, {N_CAMS} views x {N_MASKS} synthetic "
              f"masks, {round(N_FULL * 0.01)} anchors; CLIP excluded: a stand-in scores the "
              f"masks): {text_ms:.3f} ms device ({text_ms / N_CAMS:.3f} per view), host "
              f"{text_host:.3f}; {n_clusters} clusters, {int((res.labels < 0).sum())} noise masks, "
              f"{len(res.query_scales)} queries, {int(res.mask3d.sum())} Gaussians selected; "
              f"forward launches {text_fwd}  [{card}]")

        # Lift: per-mask stand-in scores, centred so that some masks count
        # against → score maps → the mask render's gradient, one forward and
        # one backward launch at C = 3 a view.
        score_maps = [clip_text.scores_to_pixel_map(
            torch.as_tensor(text_scores(v.clip_features) - 0.5, device=device),
            torch.as_tensor(v.sam_masks, device=device).to(torch.float32)) for v in views]
        state = gm.GaussianState(
            params=gm.GaussianParams(xyz=geom.xyz, features_dc=s["features_dc"],
                                     features_rest=s["features_rest"], scaling=geom.scaling,
                                     rotation=geom.rotation, opacity=geom.opacity),
            alive=alive, seg_mask=alive.to(torch.float32))
        # --- the main path: counts at 0 just before, read just after.
        FORWARD.reset_counts()
        BACKWARD.reset_counts()
        lifted, lift_ms, lift_host = timed_call(lambda: clip_text.lift_scores_to_3d(
            views, score_maps, state, config=config))
        lift_fwd, lift_bwd = dict(FORWARD.launches_by_channels), dict(BACKWARD.launches_by_channels)
        # ---
        check(lift_bwd[3] == N_CAMS and sum(lift_bwd.values()) == N_CAMS,
              f"backward launches {lift_bwd} over a lift of {N_CAMS} views")
        check(lift_fwd[3] == N_CAMS and sum(lift_fwd.values()) == N_CAMS,
              f"forward launches {lift_fwd} over a lift of {N_CAMS} views")
        check(0 < int(lifted.sum()) < N_FULL, f"lifted mask selects {int(lifted.sum())}")
        # The per-Gaussian term of view 0 (d_table's mask column) from the
        # backward kernel against blend_backward_plain on 64 seeded tiles.
        d = blend_inputs(geom.xyz, fgm.get_opacity(geom)[:, 0], fgm.get_scaling(geom),
                         fgm.get_rotation(geom), torch.zeros(N_FULL, 3, device=device), cams[0],
                         capacity, torch.zeros(3, device=device))
        grid_x, grid_y, ts = d["grid"]
        g_tiles = torch.zeros((grid_x * grid_y, ts * ts, 3), device=device)
        g_tiles[..., 0] = -to_tiles(score_maps[0], grid_x, grid_y, ts)
        tiles = seeded_tiles(d, N_SUBSET_TILES, 34)
        g_sub = torch.zeros_like(g_tiles)
        g_sub[tiles.to(device)] = g_tiles[tiles.to(device)]
        sub = subset(d, tiles)
        torch.cuda.empty_cache()
        got = run_backward(d, sub[0], sub[2], g_sub, None)[0][:, 6]
        want = run_backward_plain(d, sub[0], sub[2], g_sub, None)[0][:, 6]
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "lift: non-finite accumulator term")
        largest = float(want.abs().max())
        lift_err = float((got - want).abs().max())
        check(largest > 0 and lift_err <= TOL_GRAD * largest, f"lift accumulator term differs "
              f"from the plain version by {lift_err} of a largest {largest} (tolerance {TOL_GRAD})")
        del d, g_tiles, g_sub, score_maps
        print(f"phase 10: lift_scores_to_3d over {N_CAMS} views: {lift_ms:.3f} ms device "
              f"({lift_ms / N_CAMS:.3f} per view), host {lift_host:.3f}; {int(lifted.sum())} "
              f"Gaussians selected; forward launches {lift_fwd}, backward launches {lift_bwd}; view "
              f"0's accumulator term vs blend_backward_plain on {N_SUBSET_TILES} tiles: max "
              f"|kernel - plain| {lift_err:.3g} of a largest {largest:.3g}  [{card}]")

        # cluster_features: k = 32 on a 2 % subsample, 20 Lloyd iterations.
        gated = queries.gate_features(fs.point_features, gate, scale)
        centers, cl_ms, cl_host = timed_call(lambda: clustering.cluster_features(
            gated, k=32, sample_rate=0.02, iters=20,
            generator=torch.Generator(device=device).manual_seed(33)))
        check(tuple(centers.shape) == (32, 32) and bool(torch.isfinite(centers).all()),
              "cluster centers")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print(f"phase 10: cluster_features (k=32, {int(N_FULL * 0.02)} of {N_FULL} points, 20 "
              f"iterations): {cl_ms:.3f} ms device, host {cl_host:.3f}; peak memory over the phase "
              f"{peak_gb:.2f} GB  [{card}]")
    return {"point_fwd": point_fwd[32], "text_fwd": text_fwd[32], "lift_fwd": lift_fwd[3],
            "lift_bwd": lift_bwd[3], "pixel_err": pixel_err, "lift_err": lift_err}


def phase_segment_cli(device, card, model_dir) -> dict:
    """cli/prompt_segment.py on phase 6's scene and phase 9's feature field,
    on phase 9's copy of examples/synth_scene."""
    from PIL import Image

    from seganygaussians_torch.cli import get_clip_features, prompt_segment, render
    from seganygaussians_torch.data import ply
    from seganygaussians_torch.ops.blend_cuda import BACKWARD, FORWARD
    from seganygaussians_torch.ops.quantile import apply_quantile_transform, fit_quantile_transform
    from seganygaussians_torch.seg import clip_text

    src = os.path.join(model_dir, "scene_copy")
    common = ["-s", src, "-m", model_dir, "--device", str(device), "--raster_capacity", "32768"]
    # The click: the centre of view 0's largest SAM mask, at that mask's
    # quantile-normalised scale among all training masks' scales.
    sam = torch.load(os.path.join(src, "sam_masks", "view_000.pt"), weights_only=False).numpy()
    k = int(np.argmax(sam.sum(axis=(1, 2))))
    clicked = sam[k]
    ys, xs = np.nonzero(clicked)
    x, y = int(round(xs.mean())), int(round(ys.mean()))
    check(bool(clicked[y, x]), "the centre of the clicked mask lies outside it")
    scale_dir = os.path.join(src, "mask_scales")
    scales = [torch.load(os.path.join(scale_dir, f), weights_only=False).float().reshape(-1)
              for f in sorted(os.listdir(scale_dir))]
    q = float(apply_quantile_transform(fit_quantile_transform(torch.cat(scales)),
                                       scales[0][k : k + 1])[0])
    out = os.path.join(model_dir, "seg_point")
    FORWARD.reset_counts()
    t0 = time.perf_counter()
    check(prompt_segment.main(common + ["--point", str(x), str(y), "--scale", f"{q:.6f}",
                                        "--out", out]) == 0, "cli/prompt_segment.py --point failed")
    torch.cuda.synchronize()
    point_s = time.perf_counter() - t0
    point_fwd = FORWARD.launches_by_channels[32]
    check(point_fwd == 1, f"the point prompt launched the C=32 forward kernel {point_fwd} times")
    mask = torch.load(os.path.join(out, "final_mask.pt"), weights_only=False)
    (it,) = [d for d in os.listdir(os.path.join(model_dir, "point_cloud"))
             if os.path.exists(os.path.join(model_dir, "point_cloud", d, "seg_point_cloud.ply"))]
    n_scene = len(ply.load_gaussians_ply(os.path.join(
        model_dir, "point_cloud", it, "scene_point_cloud.ply"))["xyz"])
    n_sel = int(mask.sum())
    check(0 < n_sel < n_scene, f"the point prompt selected {n_sel} of {n_scene} Gaussians")
    check(render.main(common + ["--target", "seg", "--skip_test"]) == 0,
          "cli/render.py --target seg failed")
    (ours,) = os.listdir(os.path.join(model_dir, "seg"))
    mask_png = os.path.join(model_dir, "seg", ours, "train", "masks", "00000.png")
    rendered = np.asarray(Image.open(mask_png)) > 127
    iou = float((rendered & clicked).sum() / (rendered | clicked).sum())
    print(f"phase 11: cli/prompt_segment.py --point {x} {y} (the centre of view 0's largest SAM "
          f"mask, {int(clicked.sum())} px) --scale {q:.4f}: {n_sel} of {n_scene} Gaussians in "
          f"{point_s:.1f} s (scene load included); the segmented PLY rendered through "
          f"cli/render.py --target seg: IoU with the clicked mask in view 0 {iou:.3f} (gate "
          f"{IOU_GATE})  [{card}]")
    check(iou >= IOU_GATE, f"IoU of the segmented render with the clicked mask {iou:.3f} < "
          f"{IOU_GATE}")

    try:
        prompt_segment.main(common + ["--text", "a blue blob", "--out", out])
    except RuntimeError as e:
        check("CLIP weights unavailable" in str(e), f"--text without weights raised {e}")
    else:
        check(False, "--text without CLIP weights did not raise")
    print("phase 11: --text without CLIP weights raised 'CLIP weights unavailable'")

    real = clip_text.ClipEncoder
    clip_text.ClipEncoder = lambda **kw: real(_impl=StandInClip())
    try:
        check(get_clip_features.main(["--image_root", src, "--device", str(device)]) == 0,
              "cli/get_clip_features.py failed")
        out = os.path.join(model_dir, "seg_lift")
        FORWARD.reset_counts()
        BACKWARD.reset_counts()
        t0 = time.perf_counter()
        check(prompt_segment.main(common + ["--text", "a blue blob", "--simple_lift",
                                            "--out", out]) == 0,
              "cli/prompt_segment.py --text --simple_lift failed")
        torch.cuda.synchronize()
        lift_s = time.perf_counter() - t0
        lift_fwd, lift_bwd = FORWARD.launches_by_channels[3], BACKWARD.launches_by_channels[3]
    finally:
        clip_text.ClipEncoder = real
    n_views = len(os.listdir(os.path.join(src, "clip_features")))
    check(n_views == 48, f"{n_views} clip_features sidecars")
    check(lift_bwd == n_views and lift_fwd == n_views,
          f"--simple_lift launches: forward {lift_fwd}, backward {lift_bwd} over {n_views} views")
    n_lift = int(torch.load(os.path.join(out, "final_mask.pt"), weights_only=False).sum())
    check(n_lift > 0, "--text --simple_lift selected nothing")
    print(f"phase 11: cli/get_clip_features.py wrote {n_views} sidecars (stand-in encoder); "
          f"--text --simple_lift: {n_lift} of {n_scene} Gaussians in {lift_s:.1f} s, C=3 launches "
          f"forward {lift_fwd}, backward {lift_bwd}  [{card}]")
    return {"point_fwd": point_fwd, "lift_fwd": lift_fwd, "lift_bwd": lift_bwd, "iou": iou}


# ---------------------------------------------------------------------------
# Phase 12: the interactive session, the web GUI and the SIBR viewer
# ---------------------------------------------------------------------------


def image_tiles(img, grid_x, grid_y, ts):
    """(H, W, C) image → (T, ts², C) tile layout and the (T, ts²) mask of
    the pixels inside the frame (``tiles_to_image``'s inverse)."""
    h, w, c = img.shape
    padded = torch.zeros((grid_y * ts, grid_x * ts, c), device=img.device)
    padded[:h, :w] = img
    inside = torch.zeros((grid_y * ts, grid_x * ts), dtype=torch.bool, device=img.device)
    inside[:h, :w] = True

    def tile(x):
        return x.reshape(grid_y, ts, grid_x, ts, -1).permute(0, 2, 1, 3, 4).reshape(
            grid_x * grid_y, ts * ts, -1)

    return tile(padded), tile(inside[..., None])[..., 0]


def sibr_message(cam) -> dict:
    """The SIBR viewer's request for ``cam`` at its size: the matrices in the
    viewer's OpenGL convention, which ``ViewerRequest`` flips back."""
    view = np.array(cam.world_view, np.float64)
    view[:, 1:3] *= -1
    proj = np.array(cam.full_proj, np.float64)
    proj[:, 1] *= -1
    return {"resolution_x": cam.width, "resolution_y": cam.height, "train": 1, "keep_alive": 0,
            "fov_x": 2 * math.atan(cam.tan_fovx), "fov_y": 2 * math.atan(cam.tan_fovy),
            "z_near": 0.01, "z_far": 100.0, "scaling_modifier": 1.0, "shs_python": 0,
            "rot_scale_python": 0, "view_matrix": view.flatten().tolist(),
            "view_projection_matrix": proj.flatten().tolist()}


def sibr_request(port, msg, reply_bytes, result) -> None:
    """A SIBR client: one request; the frame, the verify string and the wall
    ms from sending to the last byte go into ``result``."""
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=120) as sock:
        payload = json.dumps(msg).encode()
        t0 = time.perf_counter()
        sock.sendall(len(payload).to_bytes(4, "little") + payload)
        buf = bytearray()
        while len(buf) < reply_bytes + 4:
            chunk = sock.recv(1 << 20)
            check(bool(chunk), "the SIBR server closed the connection early")
            buf += chunk
        n = int.from_bytes(buf[reply_bytes:reply_bytes + 4], "little")
        while len(buf) < reply_bytes + 4 + n:
            buf += sock.recv(n)
        result.update(ms=(time.perf_counter() - t0) * 1e3, img=bytes(buf[:reply_bytes]),
                      verify=bytes(buf[reply_bytes + 4:]).decode())


def phase_session(device, card, s, fs, gate, capacity) -> dict:
    """The interactive session (``viewer/interactive.py:SagaSession``) at
    full width on phase 2's 3M-Gaussian scene and phase 8's feature field and
    gate, orbiting at 1297×840; the web GUI and the SIBR viewer over
    loopback; sessions at C = 6, 16 and 24.  Returns the forward launches
    by instance."""
    import io
    import threading
    import urllib.request

    from PIL import Image

    from seganygaussians_torch.models import feature_gaussians as fgm
    from seganygaussians_torch.models import gaussians as gm
    from seganygaussians_torch.ops.blend_cuda import BACKWARD, FORWARD, instance_name
    from seganygaussians_torch.ops.quantile import fit_quantile_transform
    from seganygaussians_torch.ops.rasterize import RasterConfig
    from seganygaussians_torch.seg import queries
    from seganygaussians_torch.seg.scale_gate import init_scale_gate
    from seganygaussians_torch.viewer import interactive
    from seganygaussians_torch.viewer.network_gui import NetworkGUI
    from seganygaussians_torch.viewer.web_gui import WebGUI

    keys = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
    state = gm.from_dense(*(s[k].cpu().numpy() for k in keys), device=device)
    qt = fit_quantile_transform(torch.linspace(0.05, 3.0, 100, device=device))  # never read
    config = RasterConfig(capacity=capacity)

    def orbit():
        return interactive.OrbitState(center=np.zeros(3), radius=2.6, elevation=0.25, fovy=0.9,
                                      width=W_FULL, height=H_FULL)

    session = interactive.SagaSession(state, fs, gate, qt, config=config, seed=12)
    session.orbit = orbit()
    azimuths = [2 * math.pi * i / N_SESSION_FRAMES for i in range(N_SESSION_FRAMES)]
    with torch.no_grad():  # warm-up outside the counted window
        session.render_rgb()
        session.render_feature_map()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(41)
    issued = dict.fromkeys(("C=3", "C=32", "C=8", "C=16", "C=24"), 0)  # renders by instance
    ms = {}

    def frames(name, fn, instance):
        """Median device ms of ``fn`` over the orbit's azimuths."""
        times = []
        for az in azimuths:
            session.orbit.azimuth = az
            out, dev_ms, _ = timed_call(fn)
            times.append(dev_ms)
            issued[instance] += 1
        ms[name] = float(np.median(times))
        return out

    # --- the main path: counts at 0 just before, read just after.
    FORWARD.reset_counts()
    BACKWARD.reset_counts()
    rgb = frames("render_rgb", session.render_rgb, "C=3")
    check(rgb.shape == (H_FULL, W_FULL, 3) and np.isfinite(rgb).all() and rgb.std() > 0.01,
          "session RGB frame")
    # The feature frame and its split: CUDA events around the functions the
    # session calls (smoothing over all K, the gate, the rasterizer).
    places = [(fgm, "smoothed_point_features"), (queries, "gate_features"),
              (interactive, "rasterize")]
    spies = {name: Spy(getattr(mod, name)) for mod, name in places}
    for mod, name in places:
        setattr(mod, name, spies[name])
    try:
        fmap = frames("render_feature_map", session.render_feature_map, "C=32")
        torch.cuda.synchronize()
    finally:
        for mod, name in places:
            setattr(mod, name, spies[name].fn)
    for key, name in (("smoothing", "smoothed_point_features"), ("gate", "gate_features"),
                      ("render", "rasterize")):
        ms[f"feature_map.{key}"] = float(np.median([a.elapsed_time(b)
                                                    for a, b in spies[name].events]))
    del spies
    check(tuple(fmap.shape) == (H_FULL, W_FULL, 32) and bool(torch.isfinite(fmap).all()),
          "session feature map")
    pca = frames("render_pca", session.render_pca, "C=32")
    check(pca.shape == (H_FULL, W_FULL, 3) and np.isfinite(pca).all(), "session PCA frame")
    check(not session.render_similarity().any(), "a score map before any click")
    # One click at the frame's centre, on the ball; the clicked pixel's
    # feature from the kernel against the plain blend on its tile.
    session.orbit.azimuth = 0.0
    x, y = W_FULL // 2, H_FULL // 2
    session.click(x, y)
    fmap = session.render_feature_map()
    issued["C=32"] += 2
    check(torch.equal(session.chosen_features[0], queries.normalize(fmap[y, x])),
          "the click's prompt is not the clicked pixel's normalised feature")
    geom = fs.geom
    d = blend_inputs(geom.xyz, fgm.get_opacity(geom)[:, 0], fgm.get_scaling(geom),
                     fgm.get_rotation(geom), session._gated_gaussian_features(),
                     session.orbit.params(), capacity, torch.zeros(32, device=device))
    grid_x, _, ts = d["grid"]
    tile = (y // ts) * grid_x + x // ts
    plain = run_plain(d, *subset(d, torch.tensor([tile])))
    pixel_err = float((fmap[y, x] - plain.tiles[tile, (y % ts) * ts + x % ts]).abs().max())
    check(pixel_err <= TOL_COLOR, f"clicked pixel's feature differs from the plain blend by "
          f"{pixel_err} (tolerance {TOL_COLOR})")
    check(float(plain.final_t[tile, (y % ts) * ts + x % ts]) < 0.5, "the click hit background")
    del d, plain, fmap
    sim = frames("render_similarity", session.render_similarity, "C=32")
    check(sim.shape == (H_FULL, W_FULL) and np.isfinite(sim).all() and sim.max() > 0
          and sim.max() <= 1 + 1e-5, "session similarity map")
    _, cluster_ms, _ = timed_call(lambda: session.cluster_in_3d(k=32))
    ms["cluster_in_3d"] = cluster_ms
    check(tuple(session.cluster_centers.shape) == (32, 32), "cluster centers")
    cl = frames("render_cluster", session.render_cluster, "C=32")
    check(cl.shape == (H_FULL, W_FULL, 3) and len(np.unique(cl.reshape(-1, 3), axis=0)) > 1,
          "session cluster frame")

    # Clicks, segment3d and roll_back, one prompt each time.  The mask is
    # held against queries.segment3d on the card (what the session must
    # call) and, away from the threshold, against queries.segment3d on the
    # host on the same smoothed features (a computation the card takes no
    # part in).
    click_ms, seg_ms, undo_ms, selected, near_threshold = [], [], [], [], []
    gate_host = type(gate)(*(x.cpu() for x in gate))
    alive_before = (session.scene_state.alive.clone(), session.feature_state.geom.alive.clone())
    for i in range(N_SESSION_CLICKS):
        session.clear_clicks()
        session.orbit.azimuth = azimuths[i]
        xy = (int(W_FULL * rng.uniform(0.4, 0.6)), int(H_FULL * rng.uniform(0.4, 0.6)))
        click_ms.append(timed_call(lambda: session.click(*xy))[1])
        issued["C=32"] += 1
        # The threshold slider at the 99th percentile of the Gaussians'
        # scores (the features are nearly untrained: 0.75 may select none).
        smoothed = fgm.smoothed_point_features(session.feature_state)
        prompts = torch.stack(session.chosen_features)
        score = queries.similarity_to_prompts(
            queries.gate_features(smoothed, gate, session.scale), queries.normalize(prompts))
        session.threshold = float(torch.kthvalue(score, int(0.99 * N_FULL)).values)
        want = queries.segment3d(smoothed, gate, session.scale, prompts,
                                 threshold=session.threshold, alive=session.scene_state.alive)
        smoothed_host, prompts_host = smoothed.cpu(), prompts.cpu()
        del smoothed, score
        want_host = queries.segment3d(smoothed_host, gate_host, session.scale, prompts_host,
                                      threshold=session.threshold,
                                      alive=session.scene_state.alive.cpu())
        score_host = queries.similarity_to_prompts(
            queries.gate_features(smoothed_host, gate_host, session.scale),
            queries.normalize(prompts_host))
        far = torch.ones_like(want_host)
        far[:N_FULL] = (score_host - session.threshold).abs() > SEGMENT_MARGIN
        near_threshold.append(int((~far).sum()))
        del smoothed_host, score_host
        mask, dev_ms, _ = timed_call(session.segment3d)
        seg_ms.append(dev_ms)
        check(torch.equal(mask, want), "session.segment3d's mask differs from queries.segment3d's")
        check(torch.equal(mask.cpu()[far], want_host[far]),
              f"session.segment3d's mask differs from queries.segment3d on the host more than "
              f"{SEGMENT_MARGIN} from the threshold")
        selected.append(int(mask.sum()))
        check(torch.equal(session.scene_state.alive, mask), "segment3d did not apply its mask")
        undo_ms.append(timed_call(session.roll_back)[1])
        check(torch.equal(session.scene_state.alive, alive_before[0])
              and torch.equal(session.feature_state.geom.alive, alive_before[1]),
              "roll_back did not restore alive exactly")
    ms.update(click=float(np.median(click_ms)), segment3d=float(np.median(seg_ms)),
              roll_back=float(np.median(undo_ms)))
    # The threshold sits at the 99th percentile, so this holds by
    # construction once the slider is applied: the masks above are the check.
    check(0 < min(selected) and max(selected) < N_FULL // 50, f"segment3d selected {selected}")

    # The web GUI over loopback: wall ms per GET /render, PNG encoding
    # included (a prompt is set, so the similarity map is not zeros).
    web = WebGUI(session, port=0)
    host, port = web.start_background()
    web_ms = {}
    try:
        for mode in ("rgb", "similarity"):
            times = []
            for az in azimuths[:N_WEB_REQUESTS]:
                url = f"http://{host}:{port}/render?mode={mode}&az={az}&el=0.25&r=2.6"
                t0 = time.perf_counter()
                with urllib.request.urlopen(url, timeout=120) as r:
                    png = r.read()
                times.append((time.perf_counter() - t0) * 1e3)
                issued["C=3" if mode == "rgb" else "C=32"] += 1
            img = np.asarray(Image.open(io.BytesIO(png)))
            check(img.shape == (H_FULL, W_FULL, 3) and img.std() > 1, f"web {mode} PNG")
            web_ms[mode] = float(np.median(times))
    finally:
        web.shutdown()

    # One SIBR request over loopback, answered by render_view at SH degree 3
    # as the trainer's poll answers it.
    cam = interactive.OrbitState(center=np.zeros(3), radius=2.6, azimuth=0.7, elevation=0.25,
                                 fovy=0.9, width=W_FULL, height=H_FULL).params()
    sibr = NetworkGUI(port=0)
    reply = {}
    client = threading.Thread(target=sibr_request, args=(
        sibr.listener.getsockname()[1], sibr_message(cam), W_FULL * H_FULL * 3, reply))
    client.start()
    try:
        deadline = time.perf_counter() + 60
        while not sibr.try_connect():
            check(time.perf_counter() < deadline, "the SIBR client did not connect")
            time.sleep(0.001)
        req = sibr.receive()
        check(req is not None and np.array_equal(req.camera.world_view, cam.world_view),
              "the SIBR request's camera")
        sibr.send(interactive.render_view(state, req.camera, sh_degree=SH_DEGREE,
                                          config=config), "chip_smoke")
        client.join(timeout=120)
        check(not client.is_alive(), "the SIBR client did not finish")
    finally:
        sibr.close()
    want = interactive.render_view(state, req.camera, sh_degree=SH_DEGREE, config=config)
    issued["C=3"] += 2
    check(reply["verify"] == "chip_smoke", "the SIBR verify string")
    check(reply["img"] == (np.clip(want, 0, 1) * 255).astype(np.uint8).tobytes(),
          "the SIBR reply's bytes differ from render_view's")

    # Sessions at feature_dim 6, 16 and 24 (6 runs on the C = 8 instance):
    # the first C feature columns and a seeded C-wide gate, one feature frame
    # each, held against the plain blend on 64 seeded tiles.
    narrow = {}
    for c in (6, 16, 24):
        fs_c = fs._replace(point_features=fs.point_features[:, :c].contiguous())
        gate_c = init_scale_gate(torch.Generator().manual_seed(c), c, device=device)
        session_c = interactive.SagaSession(state, fs_c, gate_c, qt, config=config, seed=c)
        session_c.orbit = orbit()
        fmap_c, frame_ms, _ = timed_call(session_c.render_feature_map)
        issued[instance_name(c, 16)] += 1
        narrow[c] = (session_c, fmap_c, frame_ms)
    torch.cuda.synchronize()
    launches = dict(FORWARD.launches_by_instance)
    bwd = BACKWARD.launches
    # ---
    check(launches == {k: v for k, v in issued.items() if v},
          f"session launches by instance {launches} for the renders issued {issued}")
    check(bwd == 0, f"{bwd} backward launches in the session")
    narrow_err = {}
    for c, (session_c, fmap_c, _) in narrow.items():
        d = blend_inputs(geom.xyz, fgm.get_opacity(geom)[:, 0], fgm.get_scaling(geom),
                         fgm.get_rotation(geom), session_c._gated_gaussian_features(),
                         session_c.orbit.params(), capacity, torch.zeros(c, device=device))
        grid_x, grid_y, ts = d["grid"]
        tiles = seeded_tiles(d, N_SUBSET_TILES, c)
        plain = run_plain(d, *subset(d, tiles))
        got, inside = image_tiles(fmap_c, grid_x, grid_y, ts)
        rows = tiles.to(device)
        diff = (got[rows] - plain.tiles[rows]).abs().amax(dim=-1)
        narrow_err[c] = float(torch.where(inside[rows], diff, torch.zeros_like(diff)).max())
        check(narrow_err[c] <= TOL_COLOR, f"the C={c} session's frame differs from the plain "
              f"blend by {narrow_err[c]} (tolerance {TOL_COLOR})")
        del d, plain, got
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"phase 12: session at {W_FULL}x{H_FULL}, {N_FULL} Gaussians, median device ms over "
          f"{N_SESSION_FRAMES} azimuths: " + json.dumps({k: round(v, 3) for k, v in ms.items()})
          + f"; clicks, segment3d and roll_back over {N_SESSION_CLICKS} prompts, segment3d "
          f"selected {min(selected)}..{max(selected)} Gaussians (the threshold at the 99th "
          f"percentile), equal to queries.segment3d on the card and, but for "
          f"{min(near_threshold)}..{max(near_threshold)} Gaussians within {SEGMENT_MARGIN} of "
          f"the threshold, on the host; alive restored exactly; "
          f"clicked pixel's feature vs the plain blend on its tile: max |kernel - plain| "
          f"{pixel_err:.3g}  [{card}]")
    print(f"phase 12: web GUI over loopback, wall ms per GET /render (PNG included), median of "
          f"{N_WEB_REQUESTS}: {json.dumps({k: round(v, 1) for k, v in web_ms.items()})}; one SIBR "
          f"request (render_view, SH degree {SH_DEGREE}, {W_FULL}x{H_FULL}): {reply['ms']:.1f} "
          f"ms wall, reply equal to render_view's bytes  [{card}]")
    print("phase 12: sessions at C=6, 16 and 24: " + "; ".join(
          f"C={c} frame {frame_ms:.3f} ms (device), vs the plain blend on {N_SUBSET_TILES} "
          f"tiles max |kernel - plain| {narrow_err[c]:.3g}"
          for c, (_, _, frame_ms) in narrow.items())
          + f"; forward launches by instance {launches} for the renders issued {issued}; peak "
          f"memory over the phase {peak_gb:.2f} GB  [{card}]")
    return {"launches": launches, "pixel_err": pixel_err, "narrow_err": max(narrow_err.values())}


def plain_chunks(d, tiles, g_tiles, g_final_t, chunk):
    """The forward and backward of the kernels against the plain versions on
    ``tiles``, ``chunk`` tiles at a time (tiles are independent, and the
    plain version's (instances, pixels, C) arrays bound what fits): returns
    (largest forward difference, largest backward difference, plain ms of
    the forward and of the backward, each summed over the chunks)."""
    out = run_kernel(d)
    err_f = err_b = plain_f = plain_b = 0.0
    for i in range(0, len(tiles), chunk):
        part = tiles[i:i + chunk]
        sub = subset(d, part)
        plain, ms, _ = timed_call(lambda: run_plain(d, *sub))
        err_f = max(err_f, compare(out, plain, rows=part.to(d["table"].device)))
        del plain
        got = run_backward(d, sub[0], sub[2], g_tiles, g_final_t)
        want, ms_b, _ = timed_call(lambda: run_backward_plain(d, sub[0], sub[2], g_tiles,
                                                              g_final_t))
        err_b = max(err_b, compare_grads(got, want))
        plain_f, plain_b = plain_f + ms, plain_b + ms_b
        del got, want
        torch.cuda.empty_cache()
    return err_f, err_b, plain_f, plain_b


def phase_plans(device, card, s, capacity) -> tuple[list, dict]:
    """Phase 13: the row-footprint and sort-free raster plans and C = 64 at
    full width on phase 2's scene.  Returns the C = 64 kernel entries and
    the kernels' launches by instance on each plan's main-path window."""
    from seganygaussians_torch.models import gaussians as gm
    from seganygaussians_torch.ops import blend_cuda
    from seganygaussians_torch.ops.binning import (
        expand_slots, plan_instances, sort_instances, strip_row_footprints)
    from seganygaussians_torch.ops.blend_cuda import BACKWARD, FORWARD
    from seganygaussians_torch.ops.projection import preprocess
    from seganygaussians_torch.ops.rasterize import RasterConfig, rasterize

    keys = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
    p = gm.from_dense(*(s[k].cpu().numpy() for k in keys), device=device).params
    opa, scales, rots, shs = (gm.get_opacity(p)[:, 0], gm.get_scaling(p), gm.get_rotation(p),
                              gm.get_shs(p))
    g = torch.Generator(device=device).manual_seed(31)
    feats = torch.randn(N_FULL, 64, generator=g, device=device)
    cams = orbit_cameras(N_CAMS, W_FULL, H_FULL)
    kinds = {"RGB": dict(shs=shs, sh_degree=SH_DEGREE, bg=torch.zeros(3, device=device)),
             "C=32": dict(colors=feats[:, :32].contiguous(), bg=torch.zeros(32, device=device)),
             "C=64": dict(colors=feats, bg=torch.zeros(64, device=device))}
    plans = {"rect": {}, "rows": dict(row_footprints=True),
             "sortfree": dict(backend="cuda_sortfree")}

    def frame(cam, kind, plan):
        out = rasterize(p.xyz, opa, cam, scales=scales, rotations=rots,
                        config=RasterConfig(capacity=capacity, **plans[plan]), **kinds[kind])
        check(not out.overflow, f"phase 13: the {kind} {plan} frame overflowed")
        return out

    results, launches = {}, {}
    print(f"phase 13: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated at the start")
    with torch.no_grad():
        for kind in ("RGB", "C=32"):
            for plan in plans:  # warm-up outside the counted windows
                frame(cams[0], kind, plan)
        prep_rows = preprocess(p.xyz, cams[0], scales=scales, rotations=rots, opacities=opa,
                               row_footprints=True)
        m_rows = int(prep_rows.tiles_touched.sum())
        m_rect = int(strip_row_footprints(prep_rows).tiles_touched.sum())
        # The sort-free plan's destinations are the sort's order.
        grid_x, grid_y = (W_FULL + 15) // 16, (H_FULL + 15) // 16
        rect = strip_row_footprints(prep_rows)
        slots = expand_slots(rect, grid_x, grid_y, capacity)
        gauss_s, _, starts = sort_instances(slots.slot_rank, slots.slot_tile, N_FULL,
                                            grid_x * grid_y)
        torch.cuda.reset_peak_memory_stats()
        base_peak = torch.cuda.memory_allocated()
        plan, plan_ms, _ = timed_call(lambda: plan_instances(rect, grid_x, grid_y, capacity))
        plan_peak = torch.cuda.max_memory_allocated() - base_peak
        m = slots.num_instances
        check(torch.equal(plan.tile_starts, starts), "phase 13: sort-free tile_starts differ")
        check(torch.equal(plan.sorted_gauss[:m], gauss_s[:m]),
              "phase 13: sort-free instance order differs from the sort's")
        del slots, gauss_s, starts, prep_rows, rect
        print(f"phase 13: instances of view 0: rect {m_rect}, rows {m_rows} "
              f"({m_rows / m_rect:.3f} of rect); plan_instances {plan_ms:.2f} ms, "
              f"{plan_peak / 1e9:.2f} GB above the frame's inputs, order and ranges equal to "
              f"the sort's on all {m} instances  [{card}]")
        del plan

        for kind in ("RGB", "C=32"):
            ref = frame(cams[0], kind, "rect")
            for plan in ("rows", "sortfree"):
                out = frame(cams[0], kind, plan)
                err = max(float((out.color - ref.color).abs().max()),
                          float((out.final_t - ref.final_t).abs().max()))
                check(err <= TOL_COLOR, f"phase 13: {kind} {plan} frame differs from the "
                      f"rect frame by {err}")
                check(torch.equal(out.n_contrib, ref.n_contrib),
                      f"phase 13: {kind} {plan} n_contrib differs from the rect frame's")
                results[(kind, plan, "err")] = err
            for plan in plans:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                FORWARD.reset_counts()
                ms = [timed_call(lambda: frame(cam, kind, plan))[1] for cam in cams]
                launches[(kind, plan)] = dict(FORWARD.launches_by_instance)
                results[(kind, plan, "ms")] = float(np.median(ms))
                results[(kind, plan, "peak")] = torch.cuda.max_memory_allocated() / 1e9
            del ref, out

    # One gradient through each plan on view 1, the new plans' counted and
    # held to the rect plan's: the instances the row-footprint plan drops
    # have α < 1/255 on every pixel, and the sort-free plan's are the sort's,
    # so only the atomics' order of addition differs.
    grad_err = {}
    for kind in ("RGB", "C=32"):
        grads = {}
        for plan in plans:
            leaves = {"xyz": p.xyz.detach().requires_grad_(True),
                      "opa": opa.detach().requires_grad_(True),
                      "scales": scales.detach().requires_grad_(True),
                      "rots": rots.detach().requires_grad_(True)}
            kw = dict(kinds[kind])
            field = "colors" if "colors" in kw else "shs"
            kw[field] = leaves[field] = kw[field].detach().requires_grad_(True)
            FORWARD.reset_counts()
            BACKWARD.reset_counts()
            out = rasterize(leaves["xyz"], leaves["opa"], cams[1], scales=leaves["scales"],
                            rotations=leaves["rots"],
                            config=RasterConfig(capacity=capacity, **plans[plan]), **kw)
            (out.color.square().sum() + out.final_t.sum()).backward()
            torch.cuda.synchronize()
            grads[plan] = {name: x.grad for name, x in leaves.items()}
            for name, g in grads[plan].items():
                check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0,
                      f"phase 13: {kind} {plan} gradient of {name}")
            check(BACKWARD.launches == 1 and FORWARD.launches == 1,
                  f"phase 13: {kind} {plan} gradient launches {FORWARD.launches}, "
                  f"{BACKWARD.launches}")
            if plan != "rect":
                launches[(kind, plan, "bwd")] = dict(BACKWARD.launches_by_instance)
            del out, leaves
        for plan in ("rows", "sortfree"):
            grad_err[(kind, plan)] = err = max(
                column_error(grads[plan][name], want) for name, want in grads["rect"].items())
            check(err <= TOL_GRAD, f"phase 13: {kind} {plan} gradients differ from the rect "
                  f"plan's by {err:.3g} of a column's max (tolerance {TOL_GRAD})")
        del grads
        torch.cuda.empty_cache()
    print("phase 13: gradients of xyz, opacity, scale, rotation and colour (SH for RGB) on "
          "view 1 against the rect plan's: " + ", ".join(
              f"{kind} {plan} within {e:.3g}" for (kind, plan), e in grad_err.items())
          + f" of a column's max (tolerance {TOL_GRAD})")

    # Each new plan's own instances through both kernels, held to the plain
    # version on 64 seeded tiles.
    grid = ((W_FULL + 15) // 16, (H_FULL + 15) // 16, 16)
    for kind, colors in (("RGB", None), ("C=32", feats[:, :32])):
        _, _, center = cams[0].tensors(device)
        if colors is None:
            from seganygaussians_torch.ops.sh import eval_sh_color
            colors = eval_sh_color(SH_DEGREE, shs, p.xyz, center)
        c = colors.shape[1]
        for plan in ("rows", "sortfree"):
            d = blend_inputs(p.xyz, opa, scales, rots, colors.contiguous(), cams[0], capacity,
                             torch.zeros(c, device=device), row_footprints=plan == "rows")
            if plan == "sortfree":
                prep = preprocess(p.xyz, cams[0], scales=scales, rotations=rots, opacities=opa)
                order = plan_instances(prep, grid[0], grid[1], capacity)
                m = d["num_instances"]
                d["gauss_s"], d["tile_starts"] = order.sorted_gauss, order.tile_starts
                d["tile_s"] = torch.repeat_interleave(
                    torch.arange(grid[0] * grid[1], device=device),
                    (order.tile_starts[1:] - order.tile_starts[:-1]).long())
                d["gauss_s"][m:] = N_FULL
                del prep, order
            tiles = seeded_tiles(d, N_SUBSET_TILES, 40 + c)
            g_tiles, g_final_t = grad_inputs(d, 500 + c)
            torch.cuda.empty_cache()
            err_f, err_b, _, _ = plain_chunks(d, tiles, g_tiles, g_final_t, N_SUBSET_TILES // 4)
            print(f"phase 13: {kind} {plan} plan's {d['num_instances']} instances through both "
                  f"kernels on {len(tiles)} seeded tiles: forward within {err_f:.3g}, backward "
                  f"within {err_b:.3g} of the plain version (tolerances {TOL_COLOR}, {TOL_GRAD} "
                  f"of a column's max)")
            del d, g_tiles, g_final_t
            torch.cuda.empty_cache()

    # C = 64: two launches of the C = 32 instance a call, forward and backward.
    leaves = feats.detach().requires_grad_(True)
    FORWARD.reset_counts()
    BACKWARD.reset_counts()
    out, ms64, _ = timed_call(lambda: rasterize(
        p.xyz, opa, cams[0], colors=leaves, scales=scales, rotations=rots,
        bg=torch.zeros(64, device=device), config=RasterConfig(capacity=capacity)))
    check(not out.overflow and out.color.shape == (H_FULL, W_FULL, 64), "C=64 frame")
    out.color.square().sum().backward()
    torch.cuda.synchronize()
    launches[("C=64", "fwd")] = dict(FORWARD.launches_by_instance)
    launches[("C=64", "bwd")] = dict(BACKWARD.launches_by_instance)
    check(launches[("C=64", "fwd")] == {"C=32": 2} and launches[("C=64", "bwd")] == {"C=32": 2},
          f"C=64 launches {launches[('C=64', 'fwd')]}, {launches[('C=64', 'bwd')]}")
    check(bool(torch.isfinite(leaves.grad).all()), "C=64 gradient not finite")
    del out, leaves
    d = blend_inputs(p.xyz, opa, scales, rots, feats, cams[0], capacity,
                     torch.zeros(64, device=device))
    tiles = seeded_tiles(d, N_SUBSET_TILES, 64)
    g_tiles, g_final_t = grad_inputs(d, 564)
    err_f, err_b, plain_f, plain_b = plain_chunks(d, tiles, g_tiles, g_final_t,
                                                  N_SUBSET_TILES // 4)
    fwd_ms = float(np.median(cuda_time_ms(lambda: run_kernel(d), warmup=2, iters=10)))
    res = run_kernel(d)
    args = (d["gauss_s"], d["tile_starts"], d["table"], d["bg"], g_tiles, g_final_t, res[0],
            res[1], d["grid"][0], 16)
    bwd_ms = float(np.median(cuda_time_ms(lambda: BACKWARD(*args), warmup=2, iters=10)))
    visited, included, _ = work_counts(d, res[2])
    entries = []
    for name, ms, plain_ms, (bound_ms, bound_by, _, _), err, src, line in (
            ("blend_fwd[C=64]", fwd_ms, plain_f, bound(d, visited, included), err_f,
             "blend_fwd.cu", 252),
            ("blend_bwd[C=64]", bwd_ms, plain_b, bound_backward(d, visited, included), err_b,
             "blend_bwd.cu", 397)):
        side = "fwd" if name.startswith("blend_fwd") else "bwd"
        entries.append({
            "name": name, "route": "cuda", "source": f"seganygaussians_torch/csrc/{src}",
            "replaces": f"seganygaussians_tpu/ops/blend_pallas.py:{line}",
            "launches": launches[("C=64", side)]["C=32"], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / ms, "library_ms": None,
            "instance": "two launches of C=32",
        })
        print(f"phase 13: {name} (two C=32 launches): {ms:.3f} ms at the full frame, bound "
              f"{bound_ms:.4f} ms by {bound_by}; {len(tiles)} tiles against the plain version "
              f"within {err:.3g}, plain {plain_ms:.1f} ms on them  [{card}]")
    print(f"phase 13: C=64 frame through rasterize {ms64:.3f} ms  [{card}]")
    del d, res, args, g_tiles, g_final_t
    torch.cuda.empty_cache()

    for kind in ("RGB", "C=32"):
        print(f"phase 13: {kind} frame, median device ms of {N_CAMS}: " + ", ".join(
            f"{plan} {results[(kind, plan, 'ms')]:.3f} (peak {results[(kind, plan, 'peak')]:.2f}"
            f" GB)" for plan in plans) + "; rows and sort-free within " + ", ".join(
            f"{results[(kind, plan, 'err')]:.3g}" for plan in ("rows", "sortfree"))
            + f" of rect, n_contrib equal  [{card}]")
    return entries, launches


def adam_step_error(got, want, grads) -> tuple[float, int]:
    """Largest |got − want| between two parameter tensors after one Adam
    step, and how many elements were left out.  Adam's first step moves an
    element by its learning rate times the sign of its gradient, so two
    runs whose gradients differ by float32 rounding (the backward kernel's
    atomics add in a run-dependent order) move an element whose gradient is
    within that rounding of 0 in opposite directions.  Elements whose
    reference gradient is within TOL_GRAD of its column's largest value of
    0 are left out where the two differ; the gradients themselves are held
    to each other apart from this."""
    g = grads.reshape(grads.shape[0], -1)
    small = (g.abs() <= TOL_GRAD * g.abs().amax(dim=0)).reshape(grads.shape)
    diff = (got - want).abs()
    left_out = small & (diff > 1e-6)
    return float(torch.where(left_out, torch.zeros_like(diff), diff).max()), int(left_out.sum())


def phase_parallel(device, card, s, fs, gate, capacity) -> dict:
    """Phase 14: the parallel layer.  Scene and contrastive data parallelism
    with two cameras, and the tile-sharded render and gradient with two
    slabs, each run as two ranks' work in turn on this card
    (``mesh.run_in_turn``) and held against the single-rank steps; then one
    real NCCL process group of one rank and ``make_dp_train_step`` on it.
    Returns the kernels' launches by path."""
    import socket

    import torch.distributed as dist

    from seganygaussians_torch.models import gaussians as gm
    from seganygaussians_torch.models import optim
    from seganygaussians_torch.ops import losses
    from seganygaussians_torch.ops.blend_cuda import BACKWARD, FORWARD
    from seganygaussians_torch.ops.quantile import fit_quantile_transform
    from seganygaussians_torch.ops.rasterize import RasterConfig, rasterize
    from seganygaussians_torch.ops.sh import eval_sh_color
    from seganygaussians_torch.parallel import contrastive_dp, data_parallel, tile_sharded
    from seganygaussians_torch.parallel.mesh import Layout, initialize_distributed, make_mesh
    from seganygaussians_torch.train import contrastive_trainer as ct

    launches = {}

    def counted(name, fn):
        FORWARD.reset_counts()
        BACKWARD.reset_counts()
        out = fn()
        torch.cuda.synchronize()
        launches[name] = (FORWARD.launches, BACKWARD.launches)
        return out

    keys = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
    state = gm.with_training_fields(gm.from_dense(*(s[k].cpu().numpy() for k in keys),
                                                  device=device))
    cams = orbit_cameras(2, W_FULL, H_FULL)
    batch, template = data_parallel.stack_cameras(cams)
    g = torch.Generator(device=device).manual_seed(41)
    gts = torch.rand(2, H_FULL, W_FULL, 3, generator=g, device=device)
    bg = torch.zeros(3, device=device)
    config = RasterConfig(capacity=capacity)
    hyper = gm.TrainHyper()
    extent = 2.6 * 1.1

    # --- scene DP, two ranks in turn, against the mean of the per-camera
    # gradients and one Adam step.
    dp = data_parallel.make_dp_train_step(Layout(("data",), (2,)), template, hyper, config,
                                          extent, SH_DEGREE, debug_grads=True)
    got, loss, overflow, got_grads = counted("scene_dp", lambda: dp(state, batch, gts, bg, 1))
    check(not overflow and math.isfinite(float(loss)), "phase 14: scene DP step")
    grads, losses_seq = [], []
    for cam, gt in zip(cams, gts):
        leaves = [x.detach().requires_grad_(True) for x in state.params]
        prm = gm.GaussianParams(*leaves)
        out = rasterize(prm.xyz, gm.get_opacity(prm)[:, 0], cam, shs=gm.get_shs(prm),
                        sh_degree=SH_DEGREE, scales=gm.get_scaling(prm),
                        rotations=gm.get_rotation(prm), bg=bg, active_mask=state.alive,
                        config=config)
        l_ = ((1 - hyper.lambda_dssim) * losses.l1_loss(out.color, gt)
              + hyper.lambda_dssim * (1 - losses.ssim(out.color, gt)))
        grads.append(torch.autograd.grad(l_, leaves))
        losses_seq.append(float(l_.detach()))
        del out, l_, leaves, prm
    mean = gm.GaussianParams(*((a + b) / 2 for a, b in zip(*grads)))
    want, _ = optim.adam_update(mean, state.opt, state.params,
                                gm.make_lr_tree(hyper, extent, 1))
    grad_err = max(column_error(a, b) for a, b in zip(got_grads, mean))
    check(grad_err <= TOL_GRAD, f"phase 14: DP gradients differ from the sequential mean by "
          f"{grad_err:.3g} of a column's max (tolerance {TOL_GRAD})")
    xyz_err, left_out = adam_step_error(got.params.xyz, want.xyz, mean.xyz)
    check(xyz_err <= 1e-6, f"phase 14: DP xyz after one step differs by {xyz_err}")
    check(left_out <= MAX_LEFT_OUT, f"phase 14: {left_out} xyz coordinates left out of the DP "
          f"step's comparison (at most {MAX_LEFT_OUT})")
    check(abs(float(loss) - float(np.mean(losses_seq))) <= 1e-6, "phase 14: DP loss")
    print(f"phase 14: scene DP, 2 cameras as 2 ranks in turn: parameter gradients within "
          f"{grad_err:.3g} of a column's max of the sequential mean (tolerance {TOL_GRAD}); "
          f"xyz after one step within {xyz_err:.3g} of the sequential mean-gradient step "
          f"({left_out} of {3 * N_FULL} coordinates left out, at most {MAX_LEFT_OUT}: gradient "
          f"within {TOL_GRAD} of its column's max of 0 and moved the other way); loss "
          f"{float(loss):.6f}; launches {launches['scene_dp']}")
    del got, want, grads, mean, got_grads
    torch.cuda.empty_cache()

    # --- contrastive DP at (2, 1) and (1, 2), against the single-camera steps.
    chyper = ct.ContrastiveHyper(debug_grads=True)  # the CLI's defaults
    stacks = [synthetic_masks(300 + i, N_MASKS, W_FULL, H_FULL) for i in range(2)]
    bundles = [ct.build_mask_bundle(m, sc, N_MASKS, device=device) for m, sc in stacks]
    all_scales = np.concatenate([sc for _, sc in stacks])
    consts = ct.ContrastiveConsts(
        upper_bound_scale=torch.tensor(float(all_scales.max()), device=device),
        qt=fit_quantile_transform(torch.from_numpy(all_scales).to(device)))
    gate_opt = optim.adam_init(gate)
    draws = [ct.draw_step(torch.Generator(device=device).manual_seed(60 + i), b, chyper,
                          chyper.smooth_k) for i, b in enumerate(bundles)]
    seq = [ct.contrastive_step(fs, gate, gate_opt, cam, b, consts, chyper, config, draws=d)[3]
           for cam, b, d in zip(cams, bundles, draws)]
    contrastive = {}
    for shape in ((2, 1), (1, 2)):
        d_cams = shape[0]
        step = contrastive_dp.make_dp_contrastive_step(Layout(("data", "ray"), shape), template,
                                                       chyper, config)
        res = counted(f"contrastive_dp_{shape[0]}x{shape[1]}", lambda: step(
            fs, gate, gate_opt, cams[:d_cams], contrastive_dp.stack_bundles(bundles[:d_cams]),
            consts, draws[:d_cams]))
        want = sum(a["feat_grads"] for a in seq[:d_cams]) / d_cams
        tol = 1e-6 + 1e-4 * float(want.abs().max())
        err = float((res[5] - want).abs().max())
        loss_want = float(np.mean([float(a["loss"]) for a in seq[:d_cams]]))
        check(err <= tol, f"phase 14: contrastive DP {shape} gradients differ by {err} "
              f"(tolerance {tol})")
        check(abs(float(res[3]) - loss_want) <= 1e-5 and not res[4],
              f"phase 14: contrastive DP {shape} loss {float(res[3])} against {loss_want}")
        contrastive[shape] = (err, tol)
        del res, want
    print("phase 14: contrastive DP (1000 rays, K = 16, dropout 0.5), as ranks in turn: "
          + "; ".join(f"(data, ray) = {k}: feature gradients within {e:.3g} (tolerance "
                      f"{t:.3g}), launches {launches[f'contrastive_dp_{k[0]}x{k[1]}']}"
                      for k, (e, t) in contrastive.items()))
    del seq, draws, bundles
    torch.cuda.empty_cache()

    # --- tile-sharded render and gradient, 2 slabs in turn, against the frame.
    p = state.params
    _, _, center = cams[0].tensors(device)
    with torch.no_grad():
        rgb = eval_sh_color(SH_DEGREE, gm.get_shs(p), p.xyz, center).contiguous()
    geometry = (p.xyz, gm.get_opacity(p)[:, 0].contiguous(), rgb, gm.get_scaling(p),
                gm.get_rotation(p))
    slabs = Layout(("tiles",), (2,))
    render = tile_sharded.make_tile_sharded_render(slabs, "tiles", cams[0], config)
    img, overflow = counted("tile_render", lambda: render(*geometry, bg))
    with torch.no_grad():
        ref = rasterize(geometry[0], geometry[1], cams[0], colors=rgb, scales=geometry[3],
                        rotations=geometry[4], bg=bg, config=config)
    err_img = float((img - ref.color).abs().max())
    check(not overflow and err_img <= 2e-5, f"phase 14: tile-sharded image differs by {err_img}")
    del img, ref
    loss_grad = tile_sharded.make_tile_sharded_loss_grad(slabs, "tiles", cams[0], config)
    (t_loss, overflow), t_grads = counted("tile_grad",
                                          lambda: loss_grad(*geometry, bg, gts[0]))
    leaves = [x.detach().requires_grad_(True) for x in geometry]
    out = rasterize(leaves[0], leaves[1], cams[0], colors=leaves[2], scales=leaves[3],
                    rotations=leaves[4], bg=bg, config=config)
    w_loss = torch.mean(torch.abs(out.color - gts[0]))
    w_grads = torch.autograd.grad(w_loss, leaves)
    err_loss = abs(float(t_loss) - float(w_loss.detach()))
    err_grads = [float((a - b).abs().max()) for a, b in zip(t_grads, w_grads)]
    rel_grads = [e / (float(b.abs().max()) + 1e-30) for e, b in zip(err_grads, w_grads)]
    check(not overflow and err_loss <= 1e-6, f"phase 14: tile-sharded loss differs by {err_loss}")
    check(max(err_grads) <= 1e-6, f"phase 14: tile-sharded gradients differ by {err_grads}")
    print(f"phase 14: tile-sharded, 2 slabs in turn at {W_FULL}x{H_FULL}: image within "
          f"{err_img:.3g} of the frame (launches {launches['tile_render']}); loss within "
          f"{err_loss:.3g}, gradients (xyz, opacity, color, scale, rotation) within "
          f"{max(err_grads):.3g} absolute, {max(rel_grads):.3g} of their largest value "
          f"(launches {launches['tile_grad']})  [{card}]")
    del out, w_loss, w_grads, t_grads, leaves, geometry
    torch.cuda.empty_cache()

    # --- one real NCCL process group at world size 1, and the DP step on it.
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    initialize_distributed("cuda", init_method=f"tcp://localhost:{port}", world_size=1, rank=0,
                           timeout_s=120)
    try:
        check(dist.get_backend() == "nccl", "phase 14: the process group is not NCCL")
        step = data_parallel.make_dp_train_step(make_mesh(1), template, hyper, config, extent,
                                                SH_DEGREE)
        one = (batch._replace(**{k: v[:1] for k, v in batch._asdict().items()}), gts[:1])
        step(state, one[0], one[1], bg, 1)  # warm-up
        torch.cuda.synchronize()
        FORWARD.reset_counts()
        BACKWARD.reset_counts()
        nccl_state = state
        ms = []
        for i in range(N_TRAIN_STEPS):
            (nccl_state, nccl_loss, _), t, _ = timed_call(
                lambda: step(nccl_state, one[0], one[1], bg, i + 1))
            ms.append(t)
        launches["nccl_dp"] = (FORWARD.launches, BACKWARD.launches)
    finally:
        dist.destroy_process_group()
    check(launches["nccl_dp"] == (N_TRAIN_STEPS, N_TRAIN_STEPS),
          f"phase 14: NCCL DP launches {launches['nccl_dp']}")
    check(math.isfinite(float(nccl_loss)) and bool(torch.isfinite(nccl_state.params.xyz).all()),
          "phase 14: NCCL DP step not finite")
    nccl_ms = float(np.median(ms))
    print(f"phase 14: make_dp_train_step on NCCL, world size 1, {N_FULL} Gaussians at "
          f"{W_FULL}x{H_FULL}: median {nccl_ms:.3f} ms over {N_TRAIN_STEPS} steps "
          f"(launches {launches['nccl_dp']}); multi-GPU scaling not measured (one card)  "
          f"[{card}]")
    return {"launches": launches, "nccl_ms": nccl_ms}


def build_kernels() -> None:
    """One nvcc per kernel source, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from seganygaussians_torch.ops.blend_cuda import BACKWARD, FORWARD
    from seganygaussians_torch.tools.bench_scan_variants import SCAN

    kernels = (FORWARD, BACKWARD, SCAN)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        for future in [pool.submit(k.library) for k in kernels]:
            future.result()
    print(f"kernel builds (in parallel) + load: {time.perf_counter() - t0:.1f} s")
    for kernel in kernels:
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

    def timed(name, fn, *args):
        """Run one phase and print the wall time it took."""
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        print(f"{name} took {time.perf_counter() - t0:.1f} s")
        return out

    small_errors, small_frames, edge_frames = timed("phase 1", phase_small, device)
    entries, fwd_launches, err_full, full_frames, scene, capacity = timed(
        "phase 2", phase_full, device, card, small_errors)
    timed("phase 3", phase_cli, device)
    bwd_entries, err_bwd = timed("phase 4", phase_backward, card, small_frames, edge_frames,
                                 full_frames)
    del small_frames, edge_frames, full_frames
    bwd_launches = timed("phase 5", phase_train, device, card, scene, capacity)
    entries += bwd_entries
    model_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        timed("phase 6", phase_train_cli, device, card, model_dir)
        scan_entries, err_scan = timed("phase 7", phase_scan, device, card)
        step_launches, fstate, fgate = timed("phase 8", phase_contrastive, device, card, scene,
                                             capacity)
        query = timed("phase 10", phase_queries, device, card, fstate, fgate, scene, capacity)
        session = timed("phase 12", phase_session, device, card, scene, fstate, fgate, capacity)
        plan_entries, plan_launches = timed("phase 13", phase_plans, device, card, scene,
                                            capacity)
        parallel = timed("phase 14", phase_parallel, device, card, scene, fstate, fgate,
                         capacity)
        del scene, fstate, fgate
        cli_launches, depth_entry = timed("phase 9", phase_contrastive_cli, device, card,
                                          model_dir)
        seg_cli = timed("phase 11", phase_segment_cli, device, card, model_dir)
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)
    # The C = 32 kernels' launches on this slice's paths, beside phase 2's and 5's.
    for entry in entries:
        if entry["name"].endswith("[C=32]"):
            side = "fwd" if entry["name"].startswith("blend_fwd") else "bwd"
            entry["launches_contrastive_step"] = step_launches[side]
            entry["launches_contrastive_cli"] = cli_launches[side]
    # The query layer's launches (phases 10 and 11).
    for entry in entries:
        if entry["name"] == "blend_fwd[C=32]":
            entry["launches_point_queries"] = query["point_fwd"]
            entry["launches_text_query"] = query["text_fwd"]
            entry["launches_prompt_cli"] = seg_cli["point_fwd"]
        elif entry["name"] in ("blend_fwd[C=3]", "blend_bwd[C=3]"):
            side = "fwd" if entry["name"].startswith("blend_fwd") else "bwd"
            entry["launches_lift"] = query[f"lift_{side}"]
            entry["launches_lift_cli"] = seg_cli[f"lift_{side}"]
    # Each blend instance's launches over its main-path window, whose counts
    # were set to 0 just before it: the forward's at C = 3 and 32 over phase
    # 2's renders and at 32×32 tiles over its 32×32 frames, at C = 6 (on the
    # C = 8 instance), 16 and 24 over phase 12's sessions of that width; the
    # backward's over phase 5's steps and feature-render gradients.  Phase
    # 12's session launches beside them.
    fwd_launches.update((k, v) for k, v in session["launches"].items()
                        if k in ("C=8", "C=16", "C=24"))
    for entry in entries:
        kernel, instance = entry["name"].rstrip("]").split("[")
        launches = (fwd_launches if kernel == "blend_fwd" else bwd_launches).get(instance, 0)
        check(launches > 0, f"{entry['name']} was not launched on its main path")
        entry["launches"] = launches
        if kernel == "blend_fwd" and instance in session["launches"]:
            entry["launches_session"] = session["launches"][instance]
    # Phases 13-14: the C = 3 and 32 instances' launches on each new path,
    # each window counted from 0 (every one must have launched).
    par = parallel["launches"]
    for entry in entries:
        kernel, instance = entry["name"].rstrip("]").split("[")
        if instance not in ("C=3", "C=32"):
            continue
        kind, side = ("RGB" if instance == "C=3" else "C=32"), int(kernel == "blend_bwd")
        new = {f"launches_{plan}": plan_launches[(kind, plan) if not side else
                                                 (kind, plan, "bwd")].get(instance, 0)
               for plan in ("rows", "sortfree")}
        paths = (("scene_dp", "tile_render", "tile_grad", "nccl_dp") if instance == "C=3"
                 else ("contrastive_dp_2x1", "contrastive_dp_1x2"))
        for path in paths:
            if path != "tile_render" or not side:
                new[f"launches_{path}"] = par[path][side]
        check(all(v > 0 for v in new.values()),
              f"{entry['name']} was not launched on a new path: {new}")
        entry.update(new)
    entries += plan_entries
    entries.append(depth_entry)
    entries += scan_entries
    worst = max(err_full, depth_entry["max_abs_err"], query["pixel_err"], session["pixel_err"],
                session["narrow_err"], *small_errors.values())
    print(f"max |kernel - plain| over all comparisons: forward {worst:.3g}, "
          f"backward {err_bwd:.3g} (the lift's accumulator {query['lift_err']:.3g}); scan "
          f"variants {err_scan:.3g} relative")
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
