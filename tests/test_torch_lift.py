"""Port parity for seg/clip_text.py:lift_scores_to_3d, the score-map lifting
through the mask render's gradient.

A small scene built by the JAX package is carried across as numpy arrays
(``from_jax_state``).  Two views with score maps at other resolutions than
the render (one enlarged, one shrunk: the resize's antialiasing counts) go
through the JAX package's XLA backend and the port on the CPU.  The
per-Gaussian accumulator agrees to 1e-5 of its largest magnitude (the blend's
float32 gradient sums in another order); the 3D masks are equal wherever the
accumulator lies further than that from 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seganygaussians_tpu import render as jrender
from seganygaussians_tpu.models import gaussians as jgm
from seganygaussians_tpu.ops.camera import make_camera as jmake_camera
from seganygaussians_tpu.ops.rasterize import RasterConfig as JRasterConfig
from seganygaussians_tpu.seg import clip_text as jclip
from seganygaussians_torch import render as trender
from seganygaussians_torch.models import gaussians as tgm
from seganygaussians_torch.ops.rasterize import RasterConfig
from seganygaussians_torch.seg import clip_text as tclip
from tests.test_torch_geometry import t, torch_camera

W, H, N, CAP = 64, 48, 150, 192


class View:
    def __init__(self, params):
        self.params = params


def scene(seed=0):
    rng = np.random.default_rng(seed)
    z = rng.uniform(2.0, 5.0, N)
    xyz = np.stack([rng.uniform(-0.8, 0.8, N) * z * np.tan(0.55),
                    rng.uniform(-0.8, 0.8, N) * z * np.tan(0.45), z], 1).astype(np.float32)
    jstate = jgm.from_dense(
        xyz, rng.normal(0, 0.5, (N, 1, 3)).astype(np.float32), np.zeros((N, 0, 3), np.float32),
        np.log(rng.uniform(0.05, 0.25, (N, 3))).astype(np.float32),
        rng.normal(size=(N, 4)).astype(np.float32),
        rng.normal(0.5, 1.0, (N, 1)).astype(np.float32), capacity=CAP,
    )
    keep = np.ones(CAP, bool)
    keep[rng.choice(N, 10, replace=False)] = False  # dead rows among the live ones
    jstate = jgm.segment(jstate, jnp.asarray(keep))
    tstate = tgm.from_jax_state(
        {"params": {k: np.asarray(v) for k, v in jstate.params._asdict().items()},
         "alive": np.asarray(jstate.alive), "seg_mask": np.asarray(jstate.seg_mask)},
        device="cpu",
    )
    cams = [jmake_camera(np.eye(3), np.array(tr), fovx=1.1, fovy=0.9, width=W, height=H)
            for tr in ((0.0, 0.0, 0.0), (0.3, -0.1, 0.2))]
    # Score maps at half and at twice the render's size: left half high,
    # a disc of negative scores.
    scores = []
    for (h, w) in ((H // 2, W // 2), (2 * H + 4, 2 * W - 6)):
        ys, xs = np.mgrid[:h, :w]
        s = np.where(xs < w / 2, 1.0, 0.1) - 0.8 * ((xs - 0.7 * w) ** 2 + (ys - h / 2) ** 2
                                                     < (0.2 * w) ** 2)
        scores.append((s + 0.05 * rng.normal(size=(h, w))).astype(np.float32))
    return jstate, tstate, cams, scores


def jax_accumulator(cams, scores, jstate, config):
    """The JAX package's lift, up to its threshold (the loop of
    ``seg/clip_text.py:lift_scores_to_3d``)."""
    acc = jnp.zeros((jstate.alive.shape[0],), jnp.float32)
    bg = jnp.zeros((3,), jnp.float32)
    for cam, score in zip(cams, scores):
        def neg_overlap(m):
            rendered = jrender.render_mask(cam, jstate, bg, precomputed_mask=m,
                                           config=config)["mask"]
            target = jax.image.resize(jnp.asarray(score), rendered.shape, "bilinear")
            return -jnp.sum(target * rendered)

        acc = acc - jax.grad(neg_overlap)(acc * 0.0)
    return np.asarray(acc)


def test_lift_scores_to_3d_matches_jax_xla():
    jstate, tstate, cams, scores = scene()
    jcfg = JRasterConfig(capacity=1 << 14, backend="xla")
    want_acc = jax_accumulator(cams, scores, jstate, jcfg)
    want_mask = np.asarray(jclip.lift_scores_to_3d(
        [View(c) for c in cams], [jnp.asarray(s) for s in scores], jstate, config=jcfg))
    np.testing.assert_array_equal(want_mask, (want_acc > 0) & np.asarray(jstate.alive))

    views = [View(torch_camera(c)) for c in cams]
    cfg = RasterConfig(capacity=1 << 14)
    got_acc = tclip.lift_accumulator(views, [t(s) for s in scores], tstate, cfg).numpy()
    scale = float(np.abs(want_acc).max())
    assert scale > 0
    np.testing.assert_allclose(got_acc, want_acc, atol=1e-5 * scale, rtol=0)
    got_mask = tclip.lift_scores_to_3d(views, [t(s) for s in scores], tstate, cfg).numpy()
    far = np.abs(want_acc) > 1e-5 * scale
    np.testing.assert_array_equal(got_mask[far], want_mask[far])
    assert not got_mask[~np.asarray(jstate.alive)].any()
    assert 0.1 < got_mask[:N].mean() < 0.9


def test_render_mask_carries_the_gradient_to_m():
    """``render_mask`` expands the per-Gaussian mask to three channels; the
    gradient must come back through the expand to m.  The render is linear in
    m, so the gradient's entry i equals the loss at m = e_i."""
    _, tstate, cams, _ = scene(1)
    cam = torch_camera(cams[0])
    bg = torch.zeros(3)
    cfg = RasterConfig(capacity=1 << 14)
    target = torch.from_numpy(np.random.default_rng(2).uniform(size=(H, W)).astype(np.float32))
    m = torch.zeros(CAP, requires_grad=True)
    rendered = trender.render_mask(cam, tstate, bg, precomputed_mask=m, config=cfg)["mask"]
    (g,) = torch.autograd.grad(torch.sum(target * rendered), m)
    alive = tstate.alive.numpy()
    assert float(g.abs().max()) > 0 and not g[~tstate.alive].any()
    for i in np.nonzero(alive & (g.numpy() != 0))[0][:6]:
        e = torch.zeros(CAP)
        e[i] = 1.0
        with torch.no_grad():
            one = trender.render_mask(cam, tstate, bg, precomputed_mask=e, config=cfg)["mask"]
        assert float(torch.sum(target * one)) == pytest.approx(float(g[i]), rel=1e-5, abs=1e-6)
