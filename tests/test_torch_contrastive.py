"""Port parity for train/contrastive_trainer.py and the contrastive slice as
a whole.

One ``contrastive_step`` of the JAX package and one of the port run on the
same seeded numpy scene, masks, features and gate, with the random numbers
the JAX step drew from its key replayed into the port's ``StepDraws``.  Loss
and metrics agree to 1e-5, the feature and gate gradients to 2e-4 of each
array's largest value (the JAX package's own bound for gradients through the
blend: float32 sums in another order, and the suffix-sum cancellation of the
backward).  The JAX step runs on its XLA backend and, for one case, on its
Pallas backend in interpret mode.

Then the port alone: 30 iterations of ``ContrastiveTrainer.run`` lower the
loss.  The three CLIs run in a chain in ``test_torch_contrastive_cli.py``.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from seganygaussians_tpu.models import feature_gaussians as jfgm
from seganygaussians_tpu.models import optim as joptim
from seganygaussians_tpu.ops import quantile as jq
from seganygaussians_tpu.ops.camera import make_camera as jmake_camera
from seganygaussians_tpu.ops.rasterize import RasterConfig as JRasterConfig
from seganygaussians_tpu.seg import scale_gate as jgate
from seganygaussians_tpu.train import contrastive_trainer as jct
from seganygaussians_torch.models import feature_gaussians as tfgm
from seganygaussians_torch.models import optim as toptim
from seganygaussians_torch.ops.camera import make_camera as tmake_camera
from seganygaussians_torch.ops.quantile import QuantileTransform
from seganygaussians_torch.ops.rasterize import RasterConfig as TRasterConfig
from seganygaussians_torch.seg import scale_gate as tgate
from seganygaussians_torch.train import contrastive_trainer as tct

N, CAP, D, K_SMOOTH = 300, 320, 32, 8
W, H, RAYS, MAX_MASKS = 64, 48, 64, 5
CAM = dict(fovx=1.1, fovy=0.9, width=W, height=H)


def scene_arrays(seed=5):
    """Two clusters of Gaussians in front of the camera, 4 masks padded to 5."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.normal([-0.5, 0, 3.0], 0.2, (N // 2, 3)),
                          rng.normal([0.5, 0, 3.0], 0.2, (N // 2, 3))]).astype(np.float32)
    quats = rng.normal(size=(N, 4)).astype(np.float32)
    ys, xs = np.mgrid[:H, :W]
    left = xs < W // 2
    masks = np.stack([np.ones((H, W), bool), left, ~left,
                      (ys - 24) ** 2 + (xs - 20) ** 2 < 100])
    return dict(
        xyz=pts,
        scaling=np.log(rng.uniform(0.04, 0.1, (N, 3))).astype(np.float32),
        rotation=quats,
        opacity=rng.normal(1.0, 1.0, (N, 1)).astype(np.float32),
        feats=(rng.normal(size=(CAP, D)) * 1e-2).astype(np.float32),
        gate_w=rng.uniform(-1, 1, (1, D)).astype(np.float32),
        gate_b=rng.uniform(-1, 1, D).astype(np.float32),
        masks=masks,
        mask_scales=np.array([5.0, 1.2, 1.0, 0.4], np.float32),
        all_scales=np.concatenate([[5.0, 1.2, 1.0, 0.4], rng.gamma(2.0, 0.7, 60)]).astype(np.float32),
    )


def jax_side(a, smooth_type):
    fs = jfgm.from_scene_geometry(a["xyz"], a["scaling"], a["rotation"], a["opacity"],
                                  capacity=CAP, smooth_k=K_SMOOTH)
    fs = fs._replace(point_features=jnp.asarray(a["feats"]))
    gate = jgate.ScaleGateParams(jnp.asarray(a["gate_w"]), jnp.asarray(a["gate_b"]))
    bundle = jct.build_mask_bundle(a["masks"], a["mask_scales"], MAX_MASKS)
    maps = ()
    if smooth_type == "multi_res":
        rng = np.random.default_rng(17)
        maps = tuple(jnp.asarray(rng.integers(0, N, (CAP, k))) for k in (4, 4, 16))
    consts = jct.ContrastiveConsts(
        upper_bound_scale=jnp.asarray(a["all_scales"].max(), jnp.float32),
        qt=jq.fit_quantile_transform(jnp.asarray(a["all_scales"])),
        multi_res_maps=maps,
    )
    return fs, gate, bundle, consts


def torch_side(a, jfs, jconsts):
    """The port's inputs, from the same arrays (neighbour maps and quantile
    knots are carried over: their own parity is tested elsewhere)."""
    fs = tfgm.feature_state_from_jax(jax.tree_util.tree_map(np.asarray, jfs), device="cpu")
    gate = tgate.ScaleGateParams(torch.from_numpy(a["gate_w"]), torch.from_numpy(a["gate_b"]))
    bundle = tct.build_mask_bundle(a["masks"], a["mask_scales"], MAX_MASKS, device="cpu")
    consts = tct.ContrastiveConsts(
        upper_bound_scale=torch.tensor(float(a["all_scales"].max())),
        qt=QuantileTransform(torch.tensor(np.asarray(jconsts.qt.quantiles)), False),
        multi_res_maps=tuple(torch.tensor(np.asarray(m)) for m in jconsts.multi_res_maps),
    )
    return fs, gate, bundle, consts


def replay_draws(key, jbundle, hyper) -> tct.StepDraws:
    """The random numbers ``jct.contrastive_step(key=key)`` draws, in the
    order and from the sub-keys it uses."""
    k_ray, k_scale, k_smooth = jax.random.split(key, 3)
    k1, k2, k3 = jax.random.split(k_scale, 3)
    r = hyper.num_sampled_rays
    cols = None
    if hyper.smooth_type == "traditional" and 0.0 < hyper.smooth_dropout < 1.0:
        cols = jax.random.permutation(k_smooth, K_SMOOTH)[: int(K_SMOOTH * hyper.smooth_dropout)]

    def t(x, dtype=None):
        return torch.tensor(np.asarray(x), dtype=dtype)

    return tct.StepDraws(
        ray_idx=t(jct._ray_sampling(k_ray, jbundle, r), torch.long),
        rand_idx=t(jax.random.randint(k1, (jct.NUM_SAMPLED_SCALES,), 0,
                                      jnp.maximum(jbundle.n_valid, 1)), torch.long),
        u0=t(jax.random.uniform(k2, ())),
        u_jitter=t(jax.random.uniform(k3, (jct.NUM_SAMPLED_SCALES + 2,))),
        pair_rand=t(jax.random.uniform(jax.random.fold_in(k_scale, 7), (r, r))),
        smooth_cols=None if cols is None else t(cols, torch.long),
    )


def test_pixel_weights_match_jax():
    a = scene_arrays()
    ray_idx = np.random.default_rng(3).choice(H * W, RAYS, replace=False)
    want = np.asarray(jct._pixel_weights(
        jct.build_mask_bundle(a["masks"], a["mask_scales"], MAX_MASKS), jnp.asarray(ray_idx)))
    got = tct._pixel_weights(
        tct.build_mask_bundle(a["masks"], a["mask_scales"], MAX_MASKS, device="cpu"),
        torch.from_numpy(ray_idx)).numpy()
    assert got.shape == (RAYS, RAYS) and got.min() >= 1.0 and got.max() <= 10.0 + 1e-5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_scales_and_gt_match_jax(seed):
    a = scene_arrays()
    jfs, _, jbundle, jconsts = jax_side(a, "none")
    _, _, tbundle, tconsts = torch_side(a, jfs, jconsts)
    hyper = tct.ContrastiveHyper(num_sampled_rays=RAYS, smooth_type="none")
    key = jax.random.PRNGKey(seed)
    _, k_scale, _ = jax.random.split(key, 3)
    draws = replay_draws(key, jbundle, hyper)
    want_q, want_gt = jct._sample_scales_and_gt(
        k_scale, jbundle, jnp.asarray(draws.ray_idx.numpy()), jconsts)
    got_q, got_gt = tct._sample_scales_and_gt(draws, tbundle, tconsts)
    assert got_gt.shape == (10, RAYS, RAYS)
    np.testing.assert_array_equal(got_gt.numpy(), np.asarray(want_gt))
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), atol=1e-6, rtol=0)


@pytest.mark.parametrize("smooth_type,jax_backend", [
    ("traditional", "xla"), ("multi_res", "xla"), ("none", "xla"), ("traditional", "pallas"),
])
def test_contrastive_step_matches_jax(smooth_type, jax_backend):
    a = scene_arrays()
    jhyper = jct.ContrastiveHyper(num_sampled_rays=RAYS, smooth_k=K_SMOOTH,
                                  smooth_type=smooth_type, debug_grads=True)
    thyper = tct.ContrastiveHyper(num_sampled_rays=RAYS, smooth_k=K_SMOOTH,
                                  smooth_type=smooth_type, debug_grads=True)
    jfs, jgate_p, jbundle, jconsts = jax_side(a, smooth_type)
    tfs, tgate_p, tbundle, tconsts = torch_side(a, jfs, jconsts)  # before JAX donates jfs
    key = jax.random.PRNGKey(42)
    draws = replay_draws(key, jbundle, thyper)

    jfs2, jgate2, _, jaux = jct.contrastive_step(
        jfs, jgate_p, joptim.adam_init(jgate_p), jmake_camera(np.eye(3), np.zeros(3), **CAM),
        jbundle, jconsts, key, jhyper, JRasterConfig(capacity=1 << 13, backend=jax_backend))
    tfs2, tgate2, tgate_opt, taux = tct.contrastive_step(
        tfs, tgate_p, toptim.adam_init(tgate_p), tmake_camera(np.eye(3), np.zeros(3), **CAM),
        tbundle, tconsts, thyper, TRasterConfig(capacity=1 << 13), draws=draws)

    assert not taux["overflow"] and not bool(jaux["overflow"])
    for name in ("loss", "rfn", "cosine_pos", "cosine_neg"):
        assert abs(float(taux[name]) - float(jaux[name])) <= 1e-5, (
            name, float(taux[name]), float(jaux[name]))
    grads = [("feat", taux["feat_grads"].numpy(), np.asarray(jaux["feat_grads"])),
             ("gate.w", taux["gate_grads"].w.numpy(), np.asarray(jaux["gate_grads"].w)),
             ("gate.b", taux["gate_grads"].b.numpy(), np.asarray(jaux["gate_grads"].b))]
    for name, got, want in grads:
        assert got.shape == want.shape and np.isfinite(got).all()
        scale = np.abs(want).max()
        assert scale > 0, name
        assert np.abs(got - want).max() <= 2e-4 * scale, (name, np.abs(got - want).max(), scale)
    assert np.abs(grads[0][1][N:]).max() == 0.0  # dead slots get no gradient
    # Adam's first step is lr·sign(g): compare it where the gradient is not
    # within the gradient tolerance of zero.
    for got, want, g in ((tfs2.point_features.numpy(), np.asarray(jfs2.point_features), grads[0][2]),
                         (tgate2.b.numpy(), np.asarray(jgate2.b), grads[2][2])):
        sure = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(got[sure], want[sure], atol=1e-6, rtol=0)
    assert int(tfs2.opt.count) == 1 and int(tgate_opt.count) == 1


def test_draw_step_shapes_and_ranges():
    a = scene_arrays()
    bundle = tct.build_mask_bundle(a["masks"][1:], a["mask_scales"][1:], MAX_MASKS, device="cpu")
    hyper = tct.ContrastiveHyper(num_sampled_rays=RAYS)
    g = torch.Generator().manual_seed(1)
    d = tct.draw_step(g, bundle, hyper, 16)
    assert d.ray_idx.shape == (RAYS,) and len(set(d.ray_idx.tolist())) == RAYS
    covered = a["masks"][1:].any(0).reshape(-1)
    assert covered[d.ray_idx.numpy()].all()  # rays lie under some mask
    assert d.rand_idx.shape == (8,) and 0 <= int(d.rand_idx.min()) and int(d.rand_idx.max()) < 3
    assert d.u0.shape == () and d.u_jitter.shape == (10,) and d.pair_rand.shape == (RAYS, RAYS)
    assert d.smooth_cols.shape == (8,)
    no_smoothing = dataclasses.replace(hyper, smooth_type="none")
    assert tct.draw_step(g, bundle, no_smoothing, 16).smooth_cols is None
    again = tct.draw_step(torch.Generator().manual_seed(1), bundle, hyper, 16)
    assert all(torch.equal(x, y) for x, y in zip(d, again))


class _Cam:
    def __init__(self, params, masks, scales):
        self.params, self.sam_masks, self.mask_scales = params, masks, scales


@pytest.mark.parametrize("smooth_type", ["traditional", "multi_res"])
def test_contrastive_trainer_lowers_the_loss(smooth_type):
    a = scene_arrays()
    fs = tfgm.from_scene_geometry(a["xyz"], a["scaling"], a["rotation"], a["opacity"],
                                  capacity=CAP, smooth_k=K_SMOOTH, device="cpu", seed=0)
    cam = tmake_camera(np.eye(3), np.zeros(3), **CAM)
    cams = [_Cam(cam, a["masks"], a["mask_scales"]) for _ in range(2)]
    gate = tgate.init_scale_gate(torch.Generator().manual_seed(0), D, device="cpu")
    trainer = tct.ContrastiveTrainer(
        feat_state=fs, gate_params=gate, cameras=cams,
        hyper=tct.ContrastiveHyper(num_sampled_rays=RAYS, smooth_k=K_SMOOTH,
                                   smooth_type=smooth_type),
        config=TRasterConfig(capacity=1 << 13), seed=0,
    )
    if smooth_type == "multi_res":
        assert len(trainer.consts.multi_res_maps) == 3
    trainer.run(iterations=30, log_every=1)
    ms = trainer.metrics_history
    assert len(ms) == 30
    for m in ms:
        assert all(np.isfinite(m[k]) for k in ("loss", "rfn", "cosine_pos", "cosine_neg")), m
        assert not m["overflow"]
    first = np.mean([m["loss"] for m in ms[:5]])
    last = np.mean([m["loss"] for m in ms[-5:]])
    assert last < first, (first, last)
    assert ms[-1]["cosine_pos"] > ms[-1]["cosine_neg"]
    assert bool(torch.isfinite(trainer.feat_state.point_features).all())
    assert float(trainer.feat_state.point_features.abs().max()) > 1e-2
