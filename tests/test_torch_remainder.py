"""Port parity: the last small modules.

``models/gaussians.py:get_covariance`` and ``ops/transforms.py:
unpack_symmetric`` against the JAX package on the same seeded inputs
(1e-6); LPIPS in ``SceneTrainer.eval_report`` through its seam, a seeded
stand-in network (no ``lpips`` package or weights here); ``cli/convert.py``
with COLMAP's ``subprocess.run`` mocked, against the JAX CLI on a copy of the
same folder; and ``ClipEncoder`` building on the card unless asked for
another device.
"""

import os
import shutil
import subprocess
import sys
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from seganygaussians_tpu.cli import convert as jconvert
from seganygaussians_tpu.models import gaussians as jgm
from seganygaussians_tpu.ops import transforms as jtr
from seganygaussians_torch.cli import convert as tconvert
from seganygaussians_torch.models import gaussians as tgm
from seganygaussians_torch.ops import transforms as ttr
from seganygaussians_torch.seg import clip_text as tclip
from seganygaussians_torch.train import scene_trainer as ttrainer
from seganygaussians_torch.utils import lpips_metric


def _params(seed=0, n=50):
    rng = np.random.default_rng(seed)
    arrays = dict(
        xyz=rng.normal(size=(n, 3)), features_dc=rng.normal(size=(n, 1, 3)),
        features_rest=rng.normal(size=(n, 3, 3)), scaling=rng.normal(-2.0, 0.5, (n, 3)),
        rotation=rng.normal(size=(n, 4)), opacity=rng.normal(size=(n, 1)),
    )
    return {k: v.astype(np.float32) for k, v in arrays.items()}


@pytest.mark.parametrize("scale_modifier", [1.0, 0.7])
def test_get_covariance_matches_jax(scale_modifier):
    a = _params()
    want = jgm.get_covariance(jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in a.items()}),
                              scale_modifier)
    got = tgm.get_covariance(tgm.GaussianParams(**{k: torch.from_numpy(v)
                                                   for k, v in a.items()}), scale_modifier)
    assert got.shape == (50, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_unpack_symmetric_matches_jax():
    packed = np.random.default_rng(1).normal(size=(40, 6)).astype(np.float32)
    got = ttr.unpack_symmetric(torch.from_numpy(packed))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtr.unpack_symmetric(
        jnp.asarray(packed))))
    assert torch.equal(ttr.strip_symmetric(got), torch.from_numpy(packed))
    assert torch.equal(got, got.transpose(1, 2))


class _StandInNet(torch.nn.Module):
    """A seeded two-layer feature distance in place of LPIPS's backbone."""

    def __init__(self, seed=0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.w1 = torch.randn(8, 3, 3, 3, generator=g) * 0.3
        self.w2 = torch.randn(4, 8, 1, 1, generator=g) * 0.3

    def features(self, x):
        return torch.nn.functional.conv2d(torch.relu(torch.nn.functional.conv2d(x, self.w1)),
                                          self.w2)

    def forward(self, x0, x1):
        return ((self.features(x0) - self.features(x1)) ** 2).mean()


def _trainer():
    from seganygaussians_torch.ops.camera import make_camera
    from seganygaussians_torch.ops.rasterize import RasterConfig

    rng = np.random.default_rng(2)
    n = 60
    pts = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.4, 0.4, n),
                    3 + rng.uniform(-0.3, 0.3, n)], 1).astype(np.float32)
    state = tgm.create_from_points(pts, rng.uniform(size=(n, 3)).astype(np.float32), 0, 64,
                                   device="cpu")
    cams = [types.SimpleNamespace(
        params=make_camera(np.eye(3), np.array([0.1 * i, 0, 0]), fovx=0.9, fovy=0.7,
                           width=32, height=24),
        image=rng.uniform(size=(24, 32, 3)).astype(np.float32)) for i in range(2)]
    return ttrainer.SceneTrainer(state=state, cameras=cams, spatial_lr_scale=1.0, sh_degree=0,
                                 config=RasterConfig(capacity=1 << 12)), cams


def test_lpips_in_eval_report_through_the_seam():
    """Without the ``lpips`` package the report says LPIPS is unavailable
    (None) and does not fail; with a stand-in network it is the mean of the
    network's distance between each view's clamped render and its image,
    mapped to [-1, 1], and L1/PSNR are those of the plain report."""
    assert not lpips_metric.lpips_available()
    with pytest.raises(ImportError, match="lpips"):
        lpips_metric.lpips(np.zeros((4, 4, 3)), np.zeros((4, 4, 3)))
    trainer, cams = _trainer()
    plain = trainer.eval_report(cams)
    assert trainer.eval_report(cams, with_lpips=True) == dict(plain, lpips=None)
    net = _StandInNet()
    report = trainer.eval_report(cams, with_lpips=True, lpips_net=net)
    want = []
    for cam in cams:
        img = torch.clamp(ttrainer._render_image(trainer.state, cam.params, trainer.bg, 0,
                                                 trainer.config), 0, 1)
        x0 = img.permute(2, 0, 1)[None] * 2 - 1
        x1 = torch.from_numpy(cam.image).permute(2, 0, 1)[None] * 2 - 1
        want.append(float(net(x0, x1)))
    assert report["l1"] == plain["l1"] and report["psnr"] == plain["psnr"]
    np.testing.assert_allclose(report["lpips"], np.mean(want), rtol=1e-6)
    assert report["lpips"] > 0


def _scene_folder(root):
    rng = np.random.default_rng(3)
    for sub in ("input", "images"):
        os.makedirs(os.path.join(root, sub))
        for i in range(3):
            arr = rng.integers(0, 255, (37 + i, 53, 3), dtype=np.uint8)
            Image.fromarray(arr).save(os.path.join(root, sub, f"v{i}.png"))


def _run_convert(module, root, monkeypatch, argv):
    """Run a convert CLI with COLMAP mocked: record each command; the
    undistorter writes a model into sparse/ as COLMAP does."""
    calls = []

    def fake_run(cmd, *args, **kwargs):
        calls.append([c.replace(root, "<root>") for c in cmd])
        if cmd[1] == "image_undistorter":
            os.makedirs(os.path.join(root, "sparse"), exist_ok=True)
            for name in ("cameras.bin", "images.bin", "points3D.bin"):
                with open(os.path.join(root, "sparse", name), "w") as f:
                    f.write(name)
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(subprocess, "run", fake_run)
    monkeypatch.setattr(shutil, "which", lambda name: "/bin/" + name)
    assert module.main(["-s", root, *argv]) == 0
    monkeypatch.undo()
    return calls


@pytest.mark.parametrize("argv", [["--resize"], ["--skip_matching", "--camera", "PINHOLE"]])
def test_convert_matches_jax_cli(tmp_path, monkeypatch, argv):
    roots = [str(tmp_path / name) for name in ("jax", "torch")]
    for root in roots:
        _scene_folder(root)
    want = _run_convert(jconvert, roots[0], monkeypatch, argv)
    got = _run_convert(tconvert, roots[1], monkeypatch, argv)
    assert got == want and len(got) == (1 if "--skip_matching" in argv else 4)
    for dirpath, dirnames, filenames in os.walk(roots[0]):
        rel = os.path.relpath(dirpath, roots[0])
        other = os.path.join(roots[1], rel)
        assert sorted(os.listdir(other)) == sorted(dirnames + filenames)
        for name in filenames:
            with open(os.path.join(dirpath, name), "rb") as a, \
                    open(os.path.join(other, name), "rb") as b:
                assert a.read() == b.read(), os.path.join(rel, name)
    assert sorted(os.listdir(os.path.join(roots[1], "sparse", "0"))) == [
        "cameras.bin", "images.bin", "points3D.bin"]
    if "--resize" in argv:
        assert Image.open(os.path.join(roots[1], "images_4", "v1.png")).size == (13, 9)


def test_convert_without_colmap_says_so(tmp_path, monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(SystemExit, match="not found on PATH"):
        tconvert.run_colmap(str(tmp_path))


def test_clip_encoder_builds_on_the_card_unless_asked(monkeypatch):
    """``ClipEncoder()`` with no ``device`` puts either tower on ``cuda``."""
    built = []

    class _Hf:
        def __init__(self, name, device="cpu"):
            built.append(("hf", str(device)))

    monkeypatch.setitem(sys.modules, "open_clip", None)
    monkeypatch.setattr(tclip, "_HfClipImpl", _Hf)
    tclip.ClipEncoder(backend="hf")
    tclip.ClipEncoder(backend="hf", device="cpu")

    class _Model:
        def eval(self):
            return self

        def to(self, device):
            built.append(("open_clip", str(device)))
            return self

    fake = types.ModuleType("open_clip")
    fake.create_model_and_transforms = lambda name, pretrained: (_Model(), None, None)
    fake.get_tokenizer = lambda name: None
    monkeypatch.setitem(sys.modules, "open_clip", fake)
    assert tclip.ClipEncoder().backend == "open_clip"
    assert built == [("hf", "cuda"), ("hf", "cpu"), ("open_clip", "cuda")]
