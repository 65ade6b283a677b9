"""The segmentation slice of the port as a whole.

First the point prompt's path (``cli/prompt_segment.py:point_query``: gate →
C = 32 feature render → the clicked pixel's feature → ``segment3d``) through
both packages on one small feature field: the pixel's feature agrees to
1e-5, the 3D masks are equal wherever the similarity lies more than 1e-5
from the threshold.  Then the CLIs on a copy of ``examples/synth_scene``
with a tiny saved model, on the CPU: ``--point`` (its segmented PLY, loaded
and mask-rendered as ``cli/render.py --target seg`` does, covers the clicked
SAM mask), the
clip-feature sidecars through ``cli/get_clip_features.py`` and ``--text``
(the language flow) and ``--text --simple_lift``, both with the encoder
replaced by a seeded stand-in; ``--text`` without CLIP packages raises; the
SAM CLI exits 2 without ``segment_anything``.  (A file of its own, so that a
parallel run gives it a worker of its own: it renders the 48 views twice.)
"""

import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seganygaussians_tpu.models import feature_gaussians as jfgm
from seganygaussians_tpu.ops.camera import make_camera as jmake_camera
from seganygaussians_tpu.ops.rasterize import RasterConfig as JRasterConfig
from seganygaussians_tpu.ops.rasterize import rasterize as jrasterize
from seganygaussians_tpu.seg import queries as jq
from seganygaussians_tpu.seg.scale_gate import ScaleGateParams as JGate
from seganygaussians_torch import render as trender
from seganygaussians_torch.cli import prompt_segment as tps
from seganygaussians_torch.models import feature_gaussians as tfgm
from seganygaussians_torch.ops.rasterize import RasterConfig
from seganygaussians_torch.seg import clip_text as tclip
from seganygaussians_torch.seg import scale_gate as tgate
from tests.test_torch_geometry import t, torch_camera
from tests.test_torch_seg import _DetImpl

ROOT = os.path.join(os.path.dirname(__file__), "..")
# Centres of examples/synth_scene's three objects (tools/make_synth_scene.py).
OBJECT_CENTERS = np.array([(-0.8, 0.0, 0.0), (0.6, -0.1, 0.5), (0.0, 0.25, -0.6)], np.float32)


def test_point_query_matches_jax():
    rng = np.random.default_rng(0)
    n, d, w, h = 400, 32, 64, 48
    z = rng.uniform(2.0, 5.0, n)
    xyz = np.stack([rng.uniform(-0.8, 0.8, n) * z * np.tan(0.55),
                    rng.uniform(-0.8, 0.8, n) * z * np.tan(0.45), z], 1).astype(np.float32)
    # Features by the side of the frame the point is on, plus noise.
    dirs = rng.normal(size=(2, d))
    feats = (dirs[(xyz[:, 0] > 0).astype(int)] + 0.4 * rng.normal(size=(n, d))).astype(np.float32)
    geom = dict(xyz=xyz, scaling=np.log(rng.uniform(0.05, 0.2, (n, 3))).astype(np.float32),
                rotation=rng.normal(size=(n, 4)).astype(np.float32),
                opacity=rng.normal(1.0, 1.0, (n, 1)).astype(np.float32),
                alive=np.ones(n, bool))
    gw = rng.normal(0, 0.5, (1, d)).astype(np.float32)
    gb = rng.normal(1.5, 0.5, (d,)).astype(np.float32)
    cam = jmake_camera(np.eye(3), np.zeros(3), fovx=1.1, fovy=0.9, width=w, height=h)
    xy, scale, thr = (20, 30), 0.4, 0.75
    alive = np.zeros(512, bool)
    alive[:n] = True

    # The JAX package's point flow (cli/prompt_segment.py, --point), on XLA.
    jgate = JGate(jnp.asarray(gw), jnp.asarray(gb))
    jgeom = jfgm.FrozenGeometry(**{k: jnp.asarray(v) for k, v in geom.items()})
    gated = jq.gate_features(jnp.asarray(feats), jgate, jnp.asarray(scale))
    fmap = jrasterize(jgeom.xyz, jfgm.get_opacity(jgeom)[:, 0], cam, colors=gated,
                      scales=jfgm.get_scaling(jgeom), rotations=jfgm.get_rotation(jgeom),
                      bg=jnp.zeros((d,), jnp.float32), active_mask=jgeom.alive,
                      config=JRasterConfig(capacity=1 << 14, backend="xla")).color
    prompt = fmap[xy[1], xy[0]]
    prompt = prompt / jnp.linalg.norm(prompt).clip(1e-9)
    want = np.asarray(jq.segment3d(jnp.asarray(feats), jgate, jnp.asarray(scale), prompt[None],
                                   threshold=thr, alive=jnp.asarray(alive)))
    score = np.asarray(jq.similarity_to_prompts(gated, prompt[None]))

    fs = tfgm.FeatureState(
        geom=tfgm.FrozenGeometry(**{k: t(v) for k, v in geom.items()}), point_features=t(feats),
        smooth_map=torch.zeros((n, 1), dtype=torch.long), opt=None)
    tg = tgate.ScaleGateParams(t(gw), t(gb))
    cfg = RasterConfig(capacity=1 << 14)
    got_map = tps.render_feature_map(fs, tps.queries.gate_features(fs.point_features, tg, scale),
                                     torch_camera(cam), cfg)
    np.testing.assert_allclose(got_map[xy[1], xy[0]].numpy(), np.asarray(fmap[xy[1], xy[0]]),
                               atol=1e-5, rtol=0)
    got = tps.point_query(fs, tg, torch_camera(cam), xy, scale, thr, t(alive), cfg).numpy()
    assert got.shape == (512,) and not got[n:].any()
    far = np.abs(score - thr) > 1e-5
    np.testing.assert_array_equal(got[:n][far], want[:n][far])
    assert (~far).sum() <= 2
    assert 0.2 < got[:n].mean() < 0.8


def saved_model(src, model, rng):
    """A tiny trained-looking model of the synth scene at iteration 1: scene
    Gaussians on its sparse points, contrastive features by object (each
    object's direction, the ground's, plus noise) and a flat scale gate."""
    from seganygaussians_torch.data import ply

    pts, cols = ply.load_point_cloud_ply(os.path.join(src, "sparse", "0", "points3D.ply"))
    n = 1500
    pick = rng.integers(0, len(pts), n)
    xyz = (pts[pick] + rng.normal(0, 0.02, (n, 3))).astype(np.float32)
    scaling = np.log(rng.uniform(0.03, 0.08, (n, 3))).astype(np.float32)
    rotation = rng.normal(size=(n, 4)).astype(np.float32)
    opacity = np.full((n, 1), 2.0, np.float32)
    it = os.path.join(model, "point_cloud", "iteration_1")
    ply.save_gaussians_ply(
        os.path.join(it, "scene_point_cloud.ply"), xyz,
        ((cols[pick] - 0.5) / 0.2821)[:, None, :].astype(np.float32),
        np.zeros((n, 15, 3), np.float32), opacity, scaling, rotation)
    dist = np.linalg.norm(xyz[:, None] - OBJECT_CENTERS[None], axis=-1)
    obj = np.where(xyz[:, 1] > 0.45, 3, np.argmin(dist, axis=1))  # 3: the ground slab
    dirs = rng.normal(size=(4, 32))
    feats = (dirs[obj] + 0.2 * rng.normal(size=(n, 32))).astype(np.float32)
    ply.save_feature_gaussians_ply(os.path.join(it, "contrastive_feature_point_cloud.ply"),
                                   xyz, feats, opacity, scaling, rotation)
    tgate.save_scale_gate(os.path.join(it, "scale_gate.pt"),
                          tgate.ScaleGateParams(torch.zeros(1, 32), torch.zeros(32)))
    return n


def test_prompt_segment_cli_chain_on_synth_scene(tmp_path, monkeypatch, capsys):
    from seganygaussians_torch.cli import extract_segment_everything_masks as sam_cli
    from seganygaussians_torch.cli import get_clip_features
    from seganygaussians_torch.scene import ModelConfig, Scene

    src = str(tmp_path / "scene")
    shutil.copytree(os.path.join(ROOT, "examples", "synth_scene"), src)
    model = str(tmp_path / "model")
    n = saved_model(src, model, np.random.default_rng(3))
    # Views at half resolution (100×75): the SAM masks stay at 200×150, so
    # the text flows also resize them down.
    common = ["-s", src, "-m", model, "--device", "cpu", "--raster_capacity", "65536",
              "-r", "2"]
    it = os.path.join(model, "point_cloud", "iteration_1")

    # --point at the centre of view 0's largest SAM mask, at half resolution.
    sam = torch.load(os.path.join(src, "sam_masks", "view_000.pt"), weights_only=False).numpy()
    clicked = sam[int(np.argmax(sam.sum(axis=(1, 2))))][::2, ::2]
    ys, xs = np.nonzero(clicked)
    x, y = int(round(xs.mean())), int(round(ys.mean()))
    assert clicked[y, x]
    out = str(tmp_path / "seg_point")
    assert tps.main(common + ["--point", str(x), str(y), "--out", out]) == 0
    mask = torch.load(os.path.join(out, "final_mask.pt"), weights_only=False)
    assert mask.dtype == torch.bool and mask.shape[0] >= n
    assert 0 < int(mask.sum()) < n and not mask[n:].any()
    assert os.path.exists(os.path.join(it, "seg_point_cloud.ply"))
    # The segmented PLY as cli/render.py --target seg loads it, and view 0's
    # 2D mask as that CLI draws it (mask render > 0.5).
    scene = Scene(ModelConfig(source_path=src, model_path=model, resolution=2),
                  load_iteration=-1, target="seg", mode="eval", shuffle=False, device="cpu")
    assert int(scene.gaussians.alive.sum()) == int(mask.sum())
    rendered = trender.render_mask(scene.get_train_cameras()[0].params, scene.gaussians,
                                   torch.zeros(3), config=RasterConfig(capacity=65536))
    rendered = rendered["mask"].numpy() > 0.5
    iou = (rendered & clicked).sum() / (rendered | clicked).sum()
    assert iou >= 0.5, iou

    # Clip-feature sidecars through the CLI's function, with a seeded
    # stand-in encoder in place of CLIP.
    real = tclip.ClipEncoder
    monkeypatch.setattr(tclip, "ClipEncoder", lambda **kw: real(_impl=_DetImpl()))
    assert get_clip_features.main(["--image_root", src, "--device", "cpu"]) == 0
    sidecars = sorted(os.listdir(os.path.join(src, "clip_features")))
    assert len(sidecars) == 48
    feats = torch.load(os.path.join(src, "clip_features", sidecars[0]), weights_only=False)
    assert tuple(feats.shape) == (len(sam), _DetImpl.dim)

    capsys.readouterr()
    for flag, name in ((None, "seg_text"), ("--simple_lift", "seg_lift")):
        out = str(tmp_path / name)
        argv = common + ["--text", "red blob", "--out", out] + ([flag] if flag else [])
        assert tps.main(argv) == 0
        assert "CLIP encoder backend: injected" in capsys.readouterr().out
        mask = torch.load(os.path.join(out, "final_mask.pt"), weights_only=False)
        assert mask.dtype == torch.bool and mask.shape[0] >= n and not mask[n:].any()
        if flag:
            assert int(mask.sum()) > 0

    # Without CLIP packages the text prompt raises; nothing falls back.
    monkeypatch.setattr(tclip, "ClipEncoder", real)
    monkeypatch.setitem(sys.modules, "open_clip", None)
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(RuntimeError, match="CLIP weights unavailable"):
        tps.main(common + ["--text", "red blob", "--out", str(tmp_path / "seg_none")])

    monkeypatch.setitem(sys.modules, "segment_anything", None)
    with pytest.raises(SystemExit) as exc:
        sam_cli.main(["--image_root", src, "--sam_checkpoint_path", "missing.pth"])
    assert exc.value.code == 2


@pytest.mark.parametrize("kind", ["hub id", "local directory", "open_clip"])
def test_get_clip_features_routes_model_name(tmp_path, monkeypatch, kind):
    """``--model_name`` goes to the encoder argument of its kind: the JAX
    package's CLI passes an HF checkpoint name as the OpenCLIP
    ``model_name``."""
    from seganygaussians_torch.cli import get_clip_features

    (tmp_path / "images").mkdir()
    (tmp_path / "ckpt").mkdir()
    name, key = {"hub id": ("openai/clip-vit-base-patch16", "hf_model_name"),
                 "local directory": (str(tmp_path / "ckpt"), "hf_model_name"),
                 "open_clip": ("ViT-B-16", "model_name")}[kind]
    seen, real = [], tclip.ClipEncoder
    monkeypatch.setattr(tclip, "ClipEncoder",
                        lambda **kw: seen.append(kw) or real(_impl=_DetImpl()))
    assert get_clip_features.main(["--image_root", str(tmp_path), "--model_name", name,
                                   "--device", "cpu"]) == 0
    assert seen == [{key: name, "device": torch.device("cpu")}]
