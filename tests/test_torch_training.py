"""Port parity for the RGB scene-training slice, on the CPU.

The model's training functions, three ``train_step`` iterations, the
non-finite skip, a ``SceneTrainer`` run, checkpoints and the trainer CLI.
States are carried between the packages as numpy arrays (``from_jax_state``);
JAX runs its XLA blend.  Tolerances: exact for masks and integer state,
1e-6 relative for elementwise float work, and for the train steps the ones
stated at the test (gradients of a whole render agree to ~1e-5 relative, and
Adam divides by the gradient's running RMS).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from seganygaussians_tpu.data import ply as jply
from seganygaussians_tpu.models import gaussians as jgm
from seganygaussians_tpu.ops.rasterize import RasterConfig as JRasterConfig
from seganygaussians_tpu.train import scene_trainer as jtrainer
from seganygaussians_torch import checkpoint as tckpt
from seganygaussians_torch.cli import train_scene as tcli
from seganygaussians_torch.models import gaussians as tgm
from seganygaussians_torch.ops.rasterize import RasterConfig
from seganygaussians_torch.train import scene_trainer as ttrainer
from tests.test_torch_geometry import t, torch_camera
from tests.test_training import FakeCam, synthetic_scene  # noqa: F401 (fixture)

SYNTH_SCENE = os.path.join(os.path.dirname(__file__), "..", "examples", "synth_scene")
STATS = ("max_radii2d", "xyz_grad_accum", "denom")


def _jax_state(seed=4, n=30, cap=48, sh_degree=1):
    rng = np.random.default_rng(seed)
    pts = rng.normal(scale=0.4, size=(n, 3)).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    return jgm.create_from_points(pts, cols, sh_degree=sh_degree, capacity=cap)


def _close(got, want, name, rtol=1e-6, atol=1e-7):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=name)


def _assert_states_close(ts, js, rtol=1e-6, atol=1e-7, stats_rtol=None):
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    for name in tgm.GaussianParams._fields:
        _close(getattr(ts.params, name), getattr(js.params, name), name, rtol, atol)
        _close(getattr(ts.opt.mu, name), getattr(js.opt.mu, name), "mu." + name, rtol, atol)
        _close(getattr(ts.opt.nu, name), getattr(js.opt.nu, name), "nu." + name, rtol, atol)
    for name in STATS:
        _close(getattr(ts, name), getattr(js, name), name, stats_rtol or rtol, atol)
    assert int(ts.opt.count) == int(js.opt.count)


def test_create_from_points_matches_jax():
    rng = np.random.default_rng(2)
    pts = rng.normal(scale=0.5, size=(200, 3)).astype(np.float32)
    cols = rng.uniform(size=(200, 3)).astype(np.float32)
    js = jgm.create_from_points(pts, cols, sh_degree=2, capacity=256)
    ts = tgm.create_from_points(pts, cols, sh_degree=2, capacity=256, device="cpu")
    # Scales come from the Morton 3-NN search (tests/test_torch_knn.py), so
    # allow the rare point whose neighbour set differs.
    scale_ok = np.isclose(ts.params.scaling.numpy(), np.asarray(js.params.scaling), rtol=1e-5)
    assert scale_ok.mean() >= 0.99
    for name in ("xyz", "features_dc", "features_rest", "rotation", "opacity"):
        _close(getattr(ts.params, name), getattr(js.params, name), name)
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    for name in STATS:
        assert not getattr(ts, name).any()
    assert int(ts.opt.count) == 0 and not ts.opt.mu.xyz.any()


@pytest.mark.parametrize("step", [1, 700, 30_000])
def test_make_lr_tree_matches_jax(step):
    h = jgm.TrainHyper()
    want = jgm.make_lr_tree(h, 3.7, jnp.asarray(step))
    got = tgm.make_lr_tree(tgm.TrainHyper(), 3.7, step)
    for name in tgm.GaussianParams._fields:
        np.testing.assert_allclose(getattr(got, name), float(getattr(want, name)), rtol=1e-6)


def test_stats_and_opacity_reset_match_jax():
    js = _jax_state()
    ts = tgm.from_jax_state(js, device="cpu")
    rng = np.random.default_rng(8)
    for _ in range(3):
        g = rng.normal(size=(48, 2)).astype(np.float32)
        radii = rng.integers(0, 4, 48).astype(np.int32)
        js = jgm.add_densification_stats(js, jnp.asarray(g), jnp.asarray(radii))
        ts = tgm.add_densification_stats(ts, t(g), t(radii))
    js = jgm.reset_opacity(js._replace(opt=js.opt._replace(
        mu=js.opt.mu._replace(opacity=jnp.ones_like(js.opt.mu.opacity)))))
    ts = tgm.reset_opacity(ts._replace(opt=ts.opt._replace(
        mu=ts.opt.mu._replace(opacity=torch.ones_like(ts.opt.mu.opacity)))))
    _assert_states_close(ts, js)
    assert float(tgm.get_opacity(ts.params).max()) <= 0.0101


def test_densify_and_prune_matches_jax_with_its_draw(monkeypatch):
    js = _jax_state(n=40, cap=96)
    rng = np.random.default_rng(9)
    scaling = np.asarray(js.params.scaling).copy()
    scaling[:40:3] += 1.5  # large ones split, small ones clone
    js = js._replace(
        params=js.params._replace(scaling=jnp.asarray(scaling)),
        xyz_grad_accum=jnp.asarray(rng.uniform(0, 0.004, 96).astype(np.float32)),
        denom=jnp.asarray(rng.integers(0, 3, 96).astype(np.float32)),
        max_radii2d=jnp.asarray(rng.uniform(0, 30, 96).astype(np.float32)),
    )
    ts = tgm.from_jax_state(js, device="cpu")
    key = jax.random.PRNGKey(3)
    kw = dict(max_grad=0.001, min_opacity=0.005, extent=2.0, max_screen_size=20.0)
    want = jgm.densify_and_prune(js, key, **kw)

    draws = []
    for _ in range(2):  # the JAX draw, in densify_and_prune's order
        key, sub = jax.random.split(key)
        draws.append(torch.tensor(np.asarray(jax.random.normal(sub, (96, 3)))))
    monkeypatch.setattr(tgm, "split_normals", lambda generator, shape, device: draws)
    got = tgm.densify_and_prune(ts, torch.Generator(), **kw)
    assert int(got.alive.sum()) != int(ts.alive.sum())
    _assert_states_close(got, want, rtol=1e-5, atol=1e-6)


def test_train_steps_match_jax(synthetic_scene):  # noqa: F811
    cams, _ = synthetic_scene
    js = _jax_state()
    ts = tgm.from_jax_state(js, device="cpu")
    hyper = jgm.TrainHyper(lambda_dssim=0.2)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    for step in (1, 2, 3):
        cam = cams[step]
        js, jm = jtrainer.train_step(js, cam.params, jnp.asarray(cam.image), jnp.asarray(bg),
                                     jnp.asarray(step, jnp.int32), 2.5, 1, hyper,
                                     JRasterConfig(capacity=1 << 13, backend="xla"))
        ts, tm = ttrainer.train_step(ts, torch_camera(cam.params), t(cam.image), t(bg), step,
                                     2.5, 1, tgm.TrainHyper(lambda_dssim=0.2),
                                     RasterConfig(capacity=1 << 13))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        assert not bool(tm["nonfinite"]) and not tm["overflow"]
    # Adam's first steps move each parameter by about lr·sign(g), so the
    # gradients' ~1e-5 relative differences stay far below the 1e-5 absolute
    # bound; the moments and the NDC-gradient sums carry them at 1e-4.
    _assert_states_close(ts, js, rtol=1e-4, atol=1e-5)
    assert float(ts.xyz_grad_accum.max()) > 0 and float(ts.denom.max()) == 3


def test_nonfinite_step_is_skipped(synthetic_scene):  # noqa: F811
    import dataclasses

    cams, _ = synthetic_scene
    rng = np.random.default_rng(0)
    pts = rng.normal(scale=0.4, size=(30, 3)).astype(np.float32)
    cols = rng.uniform(0.2, 0.8, (30, 3)).astype(np.float32)
    state = tgm.create_from_points(pts, cols, sh_degree=0, capacity=64, device="cpu")
    good = [FakeCam(torch_camera(c.params), c.image) for c in cams[:2]]
    bad = FakeCam(dataclasses.replace(good[0].params, world_view=np.full((4, 4), np.nan,
                                                                          np.float32)),
                  good[0].image)
    trainer = ttrainer.SceneTrainer(state, [good[0], bad, good[1]], spatial_lr_scale=1.0,
                                    hyper=tgm.TrainHyper(iterations=6),
                                    config=RasterConfig(capacity=1 << 13))
    trainer.run(iterations=6, log_every=1)
    flags = [m["nonfinite"] for m in trainer.metrics_history]
    assert any(flags) and not all(flags)
    for leaf in trainer.state.params + trainer.state.opt.mu + trainer.state.opt.nu:
        assert torch.isfinite(leaf).all()


def test_scene_trainer_improves(synthetic_scene):  # noqa: F811
    cams, _ = synthetic_scene
    cams = [FakeCam(torch_camera(c.params), c.image) for c in cams]
    rng = np.random.default_rng(7)
    pts = rng.normal(scale=0.45, size=(40, 3)).astype(np.float32)
    # Capacity 128, not tests/test_training.py's 64: at 64 the first
    # densification has fewer dead slots than split children, drops parents
    # without children, and the outcome hangs on the split draw (the port's
    # torch.Generator draws are not JAX's).  At 128 every draw tried gained
    # 3-6 dB.
    state = tgm.create_from_points(pts, np.full((40, 3), 0.5, np.float32), sh_degree=0,
                                   capacity=128, device="cpu")
    hyper = tgm.TrainHyper(densify_from_iter=30, densify_until_iter=120,
                           densification_interval=40, opacity_reset_interval=10_000,
                           position_lr_max_steps=150)
    trainer = ttrainer.SceneTrainer(state=state, cameras=cams, spatial_lr_scale=2.5,
                                    hyper=hyper, sh_degree=0,
                                    config=RasterConfig(capacity=1 << 13), seed=0)
    before = trainer.psnr_on(cams)
    trainer.run(iterations=150, log_every=50)
    after = trainer.psnr_on(cams)
    losses = [m["loss"] for m in trainer.metrics_history]
    assert losses[-1] < losses[0]
    assert after > before + 1.0, (before, after)
    assert not any(m["overflow"] for m in trainer.metrics_history)
    assert torch.isfinite(trainer.state.params.xyz).all()
    report = trainer.eval_report(cams)
    np.testing.assert_allclose(report["psnr"], after, rtol=1e-6)


def test_eval_report_renders_each_view_once(synthetic_scene, monkeypatch):  # noqa: F811
    cams, _ = synthetic_scene
    cams = [FakeCam(torch_camera(c.params), c.image) for c in cams]
    state = tgm.from_jax_state(_jax_state(), device="cpu")
    trainer = ttrainer.SceneTrainer(state=state, cameras=cams, spatial_lr_scale=2.5,
                                    sh_degree=1, config=RasterConfig(capacity=1 << 13))
    calls = []
    render = ttrainer._render
    monkeypatch.setattr(ttrainer, "_render", lambda *a, **k: calls.append(1) or render(*a, **k))
    report = trainer.eval_report(cams)
    assert len(calls) == len(cams)
    assert set(report) == {"l1", "psnr"} and np.isfinite(report["psnr"])


def test_checkpoint_round_trip(tmp_path):
    ts = tgm.from_jax_state(_jax_state(), device="cpu")
    ts = tgm.add_densification_stats(ts, torch.ones(48, 2), torch.full((48,), 2, dtype=torch.int32))
    path = tckpt.save_checkpoint(str(tmp_path / "ck"), ts, 40, extra={"active_sh_degree": 1})
    assert os.path.exists(path) and os.path.exists(path + ".meta.json")
    tckpt.save_checkpoint(str(tmp_path / "ck"), ts, 7)
    assert tckpt.latest_iteration(str(tmp_path / "ck")) == 40
    template = tgm.from_jax_state(_jax_state(seed=5), device="cpu")
    back, meta = tckpt.load_checkpoint(str(tmp_path / "ck"), template)
    assert meta == {"iteration": 40, "active_sh_degree": 1}
    for a, b in zip(back.params + back.opt.mu + back.opt.nu, ts.params + ts.opt.mu + ts.opt.nu):
        assert torch.equal(a, b)
    for name in ("alive", "seg_mask") + STATS:
        assert torch.equal(getattr(back, name), getattr(ts, name))
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_checkpoint(str(tmp_path / "ck"), tgm.from_jax_state(_jax_state(cap=64),
                                                                       device="cpu"))


def test_cli_train_scene_on_cpu_writes_a_ply_jax_loads(tmp_path):
    out = tmp_path / "model"
    argv = ["-s", SYNTH_SCENE, "-m", str(out), "-r", "4", "--device", "cpu",
            "--iterations", "30", "--eval", "--test_iterations", "30",
            "--save_iterations", "30", "--checkpoint_iterations", "20",
            "--densify_from_iter", "10", "--densification_interval", "10",
            "--densify_grad_threshold", "0.001", "--disable_viewer"]
    assert tcli.main(argv) == 0
    d = jply.load_gaussians_ply(str(out / "point_cloud/iteration_30/scene_point_cloud.ply"))
    assert d["xyz"].shape[0] >= 455 and np.isfinite(d["xyz"]).all()
    assert d["features_rest"].shape[1:] == (15, 3)
    assert (out / "input.ply").exists() and (out / "cameras.json").exists()
    assert (out / "checkpoints/ckpt_20").exists()
    records = [line for line in (out / "metrics.jsonl").read_text().splitlines()
               if "test/psnr" in line]
    assert len(records) == 1
