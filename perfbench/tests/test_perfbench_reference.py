"""The plain reference (perfbench/reference) held to seganygaussians_torch's
plain path on the CPU at a small size.  The test imports the port; the
reference does not."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import scene
from perfbench.reference import features as rf
from perfbench.reference import render as rr
from perfbench.reference import train as rt
from perfbench.reference.arith import Arith, to_tf32
from seganygaussians_torch.models import feature_gaussians as fgm
from seganygaussians_torch.models import gaussians as gm
from seganygaussians_torch.ops.camera import CameraParams
from seganygaussians_torch.ops.rasterize import RasterConfig, rasterize
from seganygaussians_torch.seg import queries
from seganygaussians_torch.seg.scale_gate import ScaleGateParams
from seganygaussians_torch.train import contrastive_trainer as ct
from seganygaussians_torch.train import scene_trainer as st

N, W, H = 3000, 96, 72


def small_config():
    return {"num_gaussians": N, "sh_degree": 3, "width": W, "height": H, "fovy": 0.8,
            "views": 4, "masks_per_view": 5,
            "orbit": {"center": [0, 0, 0], "radius": 2.6, "elevation": 0.25},
            "feature": {"dim": 32, "clusters": 8, "cluster_cell": 0.3, "noise": 0.3},
            "layout": [{"shape": "ellipsoid", "share": 0.6, "center": [0, 0, 0],
                        "radii": [0.6, 0.5, 0.6], "log_scale": [-3.4, 0.3],
                        "opacity_logit": [0.5, 1.5], "color": [0.5, 0.4, 0.3]},
                       {"shape": "shell", "share": 0.4, "center": [0, 0, 0],
                        "radius_range": [4.0, 5.0], "log_scale": [-2.2, 0.3],
                        "opacity_logit": [1.0, 1.0], "color": [0.3, 0.5, 0.6]}]}


def port_camera(cam):
    return CameraParams(cam["world_view"], cam["full_proj"], cam["cam_center"], cam["width"],
                        cam["height"], cam["tan_fovx"], cam["tan_fovy"])


@pytest.fixture(scope="module")
def inputs():
    cfg = small_config()
    params = scene.gaussians(cfg, 5, "cpu")
    cam = scene.views(cfg, 5)[1]
    return cfg, params, cam


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.14159])
    y = to_tf32(x)
    assert y[0] == 1.0 and y[1] == 1.0 + 2 ** -10
    assert y[2] == 1.0  # a tie rounds to even
    assert y[3] == 1.0 + 2 ** -9
    assert abs(float(y[4]) + 3.14159) < 2 ** -9 * 4


def test_frame_matches_the_port(inputs):
    cfg, params, cam = inputs
    frame, _ = rr.render(rr.activate(params), rr.camera_on(cam, "cpu"), Arith(), 3)
    state = gm.GaussianState(gm.GaussianParams(**params), torch.ones(N, dtype=torch.bool),
                             torch.ones(N))
    out = st._render(state.params, state.alive, port_camera(cam), torch.zeros(3), 3,
                     RasterConfig(capacity=1 << 16))
    assert float(frame.image.abs().max()) > 0.1
    assert float((out.color - frame.image).abs().max()) < 1e-4
    assert frame.included == int(out.n_contrib.sum())


def test_training_step_matches_the_port(inputs):
    cfg, params, cam = inputs
    gt = scene.images(cfg, 5, "cpu")[1]
    state = gm.with_training_fields(gm.GaussianState(
        gm.GaussianParams(**params), torch.ones(N, dtype=torch.bool), torch.ones(N)))
    loss, _, grads, _, _, _ = st.view_loss_and_grads(
        state, port_camera(cam), gt, torch.zeros(3), 3, gm.TrainHyper(),
        RasterConfig(capacity=1 << 16))
    ref_loss, ref_grads, _ = rt.loss_and_grads(params, rr.camera_on(cam, "cpu"), gt, Arith())
    assert abs(float(loss) - ref_loss) < 1e-5 * ref_loss
    for k, g in zip(rt.LEAVES, grads):
        assert float((g - ref_grads[k]).norm()) <= 1e-4 * float(ref_grads[k].norm()), k
    # The control (TF32) lands well away from both.
    ctl_loss, _, _ = rt.loss_and_grads(params, rr.camera_on(cam, "cpu"), gt, Arith(True))
    assert abs(ctl_loss - ref_loss) > 100 * abs(float(loss) - ref_loss)


def test_adam_matches_the_port(inputs):
    from seganygaussians_torch.models import optim
    _, params, _ = inputs
    g = {k: torch.randn_like(v) for k, v in params.items()}
    lrs = rt.learning_rates(15001, 3.3)
    new, moments = rt.adam(params, g, {k: (torch.zeros_like(v), torch.zeros_like(v))
                                       for k, v in params.items()}, 0, lrs)
    port_p, port_opt = optim.adam_update(gm.GaussianParams(**g),
                                         optim.adam_init(gm.GaussianParams(**params)),
                                         gm.GaussianParams(**params),
                                         gm.make_lr_tree(gm.TrainHyper(), 3.3, 15001))
    for k in rt.LEAVES:
        assert torch.allclose(new[k], getattr(port_p, k), rtol=0, atol=2e-6), k


def test_features_similarity_and_segment3d_match_the_port(inputs):
    cfg, params, cam = inputs
    feats, gate = scene.features(cfg, params["xyz"], 5)
    smooth_map = fgm.build_smooth_map(params["xyz"], 16)
    fs = fgm.FeatureState(fgm.FrozenGeometry(params["xyz"], params["scaling"], params["rotation"],
                                             params["opacity"], torch.ones(N, dtype=torch.bool)),
                          feats, smooth_map, None)
    smoothed = rf.smooth(feats, smooth_map)
    assert torch.allclose(smoothed, fgm.smoothed_point_features(fs), atol=1e-6)
    gp = ScaleGateParams(gate["w"], gate["b"])
    colors = rf.gated(smoothed, gate["w"], gate["b"], 0.5)
    assert torch.allclose(colors, queries.gate_features(smoothed, gp, 0.5), atol=1e-6)
    geom = {"xyz": params["xyz"], "scales": torch.exp(params["scaling"]),
            "quats": torch.nn.functional.normalize(params["rotation"], dim=-1),
            "opacity": torch.sigmoid(params["opacity"][:, 0])}
    frame, _ = rf.feature_map(geom, colors, rr.camera_on(cam, "cpu"), Arith())
    port = rasterize(params["xyz"], geom["opacity"], port_camera(cam), colors=colors,
                     scales=geom["scales"], rotations=geom["quats"], bg=torch.zeros(32),
                     config=RasterConfig(capacity=1 << 16)).color
    assert float((port - frame.image).abs().max()) < 1e-4
    prompts = rf.normalize(frame.image[H // 2, W // 2])[None]
    sim = rf.similarity(frame.image, prompts, Arith())
    port_sim = torch.einsum("hwc,pc->hwp", queries.normalize(port), prompts).amax(-1)
    assert float((sim - port_sim).abs().max()) < 1e-4
    mask = rf.segment3d(smoothed, gate["w"], gate["b"], 0.5, prompts, Arith())
    port_mask = queries.segment3d(smoothed, gp, 0.5, prompts)
    assert float((mask != port_mask).float().mean()) < 1e-3


@pytest.mark.parametrize("smooth_type", ["traditional", "multi_res"])
def test_contrastive_step_matches_the_port(inputs, smooth_type):
    cfg, params, cam = inputs
    smooth_map = fgm.build_smooth_map(params["xyz"], 16)
    feats = 1e-2 * torch.randn(N, 32, generator=torch.Generator().manual_seed(0))
    gate = {"w": torch.rand(1, 32) * 2 - 1, "b": torch.rand(32) * 2 - 1}
    masks, scales = scene.masks(cfg, 5, 1, "cpu")
    geom_port = fgm.FrozenGeometry(params["xyz"], params["scaling"], params["rotation"],
                                   params["opacity"], torch.ones(N, dtype=torch.bool))
    fs = fgm.FeatureState(geom_port, feats, smooth_map,
                          fgm.optim.adam_init(fgm.FeatureParams(feats)))
    bundle = ct.build_mask_bundle(masks.numpy(), scales, masks.shape[0], device="cpu")
    all_scales = torch.tensor(np.concatenate([scales, scales * 1.3]))
    nbrs = (smooth_map,)
    if smooth_type == "multi_res":
        nbrs = fgm.build_multi_res_maps(fs, torch.Generator().manual_seed(4))
        assert [m.shape[1] for m in nbrs] == [4, 4, 16]
        assert torch.allclose(rf.smooth_levels(feats, nbrs),
                              fgm.multi_res_smoothed_features(fs, nbrs), atol=1e-6)
    consts = ct.ContrastiveConsts(all_scales.max(),
                                  ct.fit_quantile_transform(all_scales, output="uniform"),
                                  nbrs if smooth_type == "multi_res" else ())
    hyper = ct.ContrastiveHyper(num_sampled_rays=64, debug_grads=True, smooth_type=smooth_type)
    gp = ScaleGateParams(gate["w"], gate["b"])
    g_port = torch.Generator().manual_seed(11)
    _, _, _, aux = ct.contrastive_step(fs, gp, fgm.optim.adam_init(gp), port_camera(cam), bundle,
                                       consts, hyper, RasterConfig(capacity=1 << 16),
                                       generator=g_port)
    m = rf.sorted_masks(masks, torch.tensor(scales))
    d = rf.draw(torch.Generator().manual_seed(11), m, 64, 16, 0.5, smooth_type)
    geom = {"xyz": params["xyz"], "scales": torch.exp(params["scaling"]),
            "quats": torch.nn.functional.normalize(params["rotation"], dim=-1),
            "opacity": torch.sigmoid(params["opacity"][:, 0])}
    loss, gf, gw, gb = rf.contrastive_grads(feats, gate["w"], gate["b"], smooth_type, nbrs, geom,
                                            rr.camera_on(cam, "cpu"), m, d, all_scales.max(),
                                            rf.fit_quantiles(all_scales), Arith())
    assert abs(float(aux["loss"]) - loss) < 1e-5 * abs(loss)
    assert float((aux["feat_grads"] - gf).norm()) < 1e-4 * float(gf.norm())
    assert float((aux["gate_grads"].w - gw).norm()) < 1e-4 * float(gw.norm())
    assert float((aux["gate_grads"].b - gb).norm()) < 1e-4 * float(gb.norm())


def test_exact_neighbours_and_the_port_s_map(inputs):
    """The reference's kNN is the brute-force one; the port's map (an
    approximate kNN) misses little of it, a map with one column taken from
    another row misses about one entry in 15."""
    _, params, _ = inputs
    xyz = params["xyz"]
    rows = torch.arange(0, N, 7)
    idx, d2 = rf.nearest(xyz, rows, 15, Arith(False), block=32)
    brute = torch.cdist(xyz[rows].double(), xyz.double()) ** 2
    brute[torch.arange(rows.numel()), rows] = float("inf")
    want = torch.topk(brute, 15, dim=1, largest=False)
    assert torch.allclose(d2.double(), want.values, rtol=1e-5, atol=1e-9)
    assert rf.neighbour_misses(xyz, rows, idx, d2[:, -1]) == 0.0
    assert rf.neighbour_misses(xyz, rows, want.indices, d2[:, -1]) == 0.0
    port = fgm.build_smooth_map(xyz, 16)
    assert torch.equal(port[:, 0], torch.arange(N))
    assert rf.neighbour_misses(xyz, rows, port[rows, 1:], d2[:, -1]) < 0.01
    altered = port.clone()
    altered[:, 8] = torch.roll(port[:, 8], 1)
    assert rf.neighbour_misses(xyz, rows, altered[rows, 1:], d2[:, -1]) > 0.05
    # A repeat and the row itself are misses.
    bad = idx.clone()
    bad[:, 1] = bad[:, 0]
    bad[:, 2] = rows
    assert abs(rf.neighbour_misses(xyz, rows, bad, d2[:, -1]) - 2 / 15) < 1e-9


def test_exact_neighbours_and_the_port_s_level_maps(inputs):
    """Each multi-resolution level among its subsample, the points its map
    holds: the reference's kNN there is the brute-force one with the point
    itself first; the port's maps miss little of it and each holds every
    point of its subsample in that point's own row; a column taken from
    another row misses about one entry in K, a row without its point is a
    map fault."""
    from perfbench import cells
    _, params, _ = inputs
    xyz = params["xyz"]
    state = fgm.FeatureState(fgm.FrozenGeometry(xyz, None, None, None,
                                                torch.ones(N, dtype=torch.bool)), None, None, None)
    maps = fgm.build_multi_res_maps(state, torch.Generator().manual_seed(4))

    def faults(maps):
        return cells.map_faults(cells.Smoothing("multi_res", tuple(
            cells.Level(m, False, m.shape[1]) for m in maps), len(maps)))

    assert faults(maps) == 0.0
    rows = torch.arange(0, N, 7)
    for m, rate in zip(maps, (0.1, 0.5, 1.0)):
        k = m.shape[1]
        source = cells.level_source(m)
        assert abs(source.numel() / N - rate) < 0.05
        idx, d2 = rf.nearest(xyz, rows, k, Arith(False), block=32, source=source)
        brute = torch.cdist(xyz[rows].double(), xyz[source].double()) ** 2
        want = torch.topk(brute, k, dim=1, largest=False)
        assert torch.allclose(d2.double(), want.values, rtol=1e-5, atol=1e-9)
        assert rf.neighbour_misses(xyz, rows, idx, d2[:, -1], itself=True) == 0.0
        assert rf.neighbour_misses(xyz, rows, m[rows], d2[:, -1], itself=True) < 0.01
        altered = m.clone()
        altered[:, k // 2] = torch.roll(m[:, k // 2], 1)
        assert rf.neighbour_misses(xyz, rows, altered[rows], d2[:, -1], itself=True) > 0.5 / k
    # A subsampled point whose own row lacks it; an index out of range.
    own = maps[0].clone()
    point = int(cells.level_source(own)[0])
    own[point] = own[(point + 1) % N]
    assert faults((own,) + maps[1:]) > 0
    out = maps[1].clone()
    out[3, 1] = N
    assert abs(faults(maps[:1] + (out,) + maps[2:]) - 1 / N) < 1e-9
