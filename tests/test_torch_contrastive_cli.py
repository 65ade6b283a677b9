"""The contrastive slice of the port as a whole, through its CLIs on the CPU:
``get_scale`` → ``train_contrastive_feature`` → ``render --target
contrastive_feature`` on a copy of ``examples/synth_scene`` with a tiny saved
scene model.  (A file of its own, so that a parallel run can give it a worker
of its own: it renders 48 views three times.)
"""

import os
import shutil

import numpy as np
import torch

from seganygaussians_torch.seg import scale_gate as tgate

ROOT = os.path.join(os.path.dirname(__file__), "..")


def test_contrastive_cli_chain_on_synth_scene(tmp_path):
    """get_scale → train_contrastive_feature → render --target
    contrastive_feature on a COPY of the example scene (get_scale writes its
    sidecars into the source directory)."""
    from seganygaussians_torch.cli import get_scale, render, train_contrastive_feature
    from seganygaussians_torch.data import ply

    src = str(tmp_path / "scene")
    shutil.copytree(os.path.join(ROOT, "examples", "synth_scene"), src)
    committed = sorted(os.listdir(os.path.join(src, "mask_scales")))
    shutil.rmtree(os.path.join(src, "mask_scales"))
    model = str(tmp_path / "model")

    # a tiny saved scene model: Gaussians on the scene's sparse points
    pts, cols = ply.load_point_cloud_ply(os.path.join(src, "sparse", "0", "points3D.ply"))
    rng = np.random.default_rng(11)
    n = 1500
    pick = rng.integers(0, len(pts), n)
    ply.save_gaussians_ply(
        os.path.join(model, "point_cloud", "iteration_1", "scene_point_cloud.ply"),
        (pts[pick] + rng.normal(0, 0.02, (n, 3))).astype(np.float32),
        ((cols[pick] - 0.5) / 0.2821)[:, None, :].astype(np.float32),
        np.zeros((n, 15, 3), np.float32), np.full((n, 1), 2.0, np.float32),
        np.log(rng.uniform(0.03, 0.08, (n, 3))).astype(np.float32),
        rng.normal(size=(n, 4)).astype(np.float32),
    )
    common = ["-s", src, "-m", model, "--device", "cpu", "--raster_capacity", "65536"]

    assert get_scale.main(common) == 0
    sidecars = sorted(os.listdir(os.path.join(src, "mask_scales")))
    assert sidecars == committed and len(sidecars) == 48
    for name in sidecars:
        s = torch.load(os.path.join(src, "mask_scales", name), weights_only=False)
        masks = torch.load(os.path.join(src, "sam_masks", name), weights_only=False)
        assert s.shape == (len(masks),) and bool(torch.isfinite(s).all()) and float(s.min()) > 0

    assert train_contrastive_feature.main(
        common + ["--iterations", "5", "--num_sampled_rays", "64"]) == 0
    out = os.path.join(model, "point_cloud", "iteration_5")
    feats = ply.load_feature_gaussians_ply(
        os.path.join(out, "contrastive_feature_point_cloud.ply"))
    assert feats["features"].shape == (n, 32) and np.isfinite(feats["features"]).all()
    gate = tgate.load_scale_gate(os.path.join(out, "scale_gate.pt"), device="cpu")
    assert gate.w.shape == (1, 32) and gate.b.shape == (32,)
    assert os.path.exists(os.path.join(model, "feature_cfg_args.json"))

    assert render.main(common + ["--target", "contrastive_feature"]) == 0
    (ours,) = os.listdir(os.path.join(model, "contrastive_feature"))
    renders = os.path.join(model, "contrastive_feature", ours, "train", "renders")
    maps = sorted(os.listdir(renders))
    assert len(maps) == 48 and all(m.endswith(".npy") for m in maps)
    for name in (maps[0], maps[-1]):
        fmap = np.load(os.path.join(renders, name))
        assert fmap.shape == (150, 200, 32) and np.isfinite(fmap).all() and fmap.std() > 0
