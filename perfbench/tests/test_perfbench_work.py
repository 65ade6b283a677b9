"""The blend kernels' work counts (perfbench/work) on a frame of hand-counted
tiles, and their independence of the program's raster plan."""

from __future__ import annotations

import math

import pytest
import torch

from perfbench import scene
from perfbench.reference import render as rr
from perfbench.reference.arith import Arith
from perfbench.tests.test_perfbench_reference import port_camera, small_config
from perfbench.work import blend, step
from seganygaussians_torch.ops.rasterize import RasterConfig, rasterize


def two_tile_frame():
    """Two 16×16 tiles side by side (32×16), one round Gaussian in each, at
    pixel centres (8, 8) and (24, 8), 2D covariance 1.3·I, opacity 0.5."""
    bins = rr.Bins(gauss=torch.tensor([0, 1]), tile=torch.tensor([0, 1]),
                   tile_starts=torch.tensor([0, 1, 2]), grid=(2, 1, 16))
    means2d = torch.tensor([[8.0, 8.0], [24.0, 8.0]])
    conics = torch.tensor([[1 / 1.3, 0.0, 1 / 1.3]] * 2)
    opacity = torch.tensor([0.5, 0.5])
    colors = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    return bins, rr.blend(bins, means2d, conics, opacity, colors, torch.zeros(3), 32, 16)


def test_hand_counted_tiles():
    bins, frame = two_tile_frame()
    # α = 0.5·exp(−d²/2.6) ≥ 1/255 ⇔ d² ≤ 2.6·ln(127.5) = 12.61: the lattice
    # points of radius² 0, 1, 2, 4, 5, 8, 9, 10 — 1 + 4 + 4 + 4 + 8 + 4 + 4 + 8.
    assert frame.included == 2 * 37
    assert frame.visited == 2 * 256  # one instance a tile, T = 1 before it
    f = blend.count(bins, frame, 32, 16, 3)
    assert f == blend.Frame(instances=2, tiles=2, gaussians=2, pixels=512, channels=3,
                            visited=512, included=74)
    fwd_bytes, fwd_ops = blend.forward(f)
    assert fwd_bytes == 2 * 8 + 3 * 4 + 2 * 9 * 4 + 3 * 4 + 512 * 5 * 4
    assert fwd_ops == 14 * 512 + 9 * 74
    bwd_bytes, bwd_ops = blend.backward(f)
    assert bwd_bytes == 2 * 8 + 3 * 4 + 2 * 9 * 4 + 3 * 4 + 512 * 8 * 4 + 2 * 9 * 4
    assert bwd_ops == 14 * 512 + 47 * 74
    assert blend.least_seconds(fwd_bytes, fwd_ops) == fwd_bytes / blend.PEAK_BYTES_PER_S
    assert math.isclose(blend.least_seconds(0, 67e12), 1.0)


def test_step_models_add_the_blend_counts():
    _, frame = two_tile_frame()
    f = blend.count(*two_tile_frame(), 32, 16, 3)
    b, o = step.scene_train(10, f)
    fb, fo = blend.forward(f)
    bb, bo = blend.backward(f)
    assert b == 10 * 59 * 4 * 9 + 512 * 3 * 4 * 3 + fb + bb
    assert o > fo + bo


@pytest.mark.parametrize("plan", [dict(), dict(row_footprints=True), dict(backend="cuda_sortfree")])
def test_count_is_the_same_whichever_plan_the_port_takes(plan):
    cfg = small_config()
    params = scene.gaussians(cfg, 9, "cpu")
    cam = scene.views(cfg, 9)[2]
    act = rr.activate(params)
    frame, (bins, _, _) = rr.render(act, rr.camera_on(cam, "cpu"), Arith(), 3)
    counted = blend.count(bins, frame, cam["width"], cam["height"], 3)
    out = rasterize(params["xyz"], act["opacity"], port_camera(cam), shs=act["shs"].transpose(1, 2),
                    sh_degree=3, scales=act["scales"], rotations=act["quats"],
                    config=RasterConfig(capacity=1 << 16, **plan))
    # The count depends on the inputs alone; the port blends the same pairs
    # whichever plan it takes.
    assert counted.included == int(out.n_contrib.sum())
    assert float((out.color - frame.image).abs().max()) < 1e-4


def test_feature_step_counts_follow_the_smoothing():
    """``traditional`` (one level of ⌊K·dropout⌋ columns, no level sums) gives
    the counts the step had before the smoothing became a list of levels;
    ``multi_res`` adds one smoothing a level and three level sums of N·d."""
    f = blend.count(*two_tile_frame(), 32, 16, 32)
    assert step.feature_train(5_800_000, [8], 0, 32, 1000, 10, f) == (20460206024.0, 7859231356.0)
    assert step.feature_train(3000, [8], 0, 32, 64, 10, f) == (11361384.0, 10967676.0)
    rest = step.feature_train(3000, [], 0, 32, 64, 10, f)
    levels = [step.smoothing(3000, k, 32, True) for k in (4, 4, 16)]
    assert step.feature_train(3000, [4, 4, 16], 3, 32, 64, 10, f) == (
        rest[0] + sum(b for b, _ in levels), rest[1] + sum(o for _, o in levels) + 3 * 3000 * 32)
