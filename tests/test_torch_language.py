"""Port parity for seg/language.py, the text-prompt flow.

The same seeded numpy inputs go through the JAX package and the port on the
CPU.  The traps of this module each have a test: ``jax.image.resize(...,
"bilinear")`` antialiases when it shrinks (held to 1e-6 at factors 1, 2, 4, a
non-integer one and an enlargement), and the erosion's 3×3 window sum is
thresholded (masks compared exactly wherever the sum lies more than 1e-5
from 2; the rest counted).  Mask features agree to 1e-5, identifiers exactly
away from their 0.5 threshold, and ``text_segment`` with the JAX package's
own anchors gives equal masks and labels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seganygaussians_tpu.ops.quantile import apply_quantile_transform as japply_qt
from seganygaussians_tpu.ops.quantile import fit_quantile_transform as jfit_qt
from seganygaussians_tpu.seg import language as jl
from seganygaussians_tpu.seg.scale_gate import ScaleGateParams as JGate
from seganygaussians_tpu.seg.scale_gate import apply_scale_gate as japply_gate
from seganygaussians_torch.ops.quantile import fit_quantile_transform as tfit_qt
from seganygaussians_torch.preprocess import box_sum_3x3
from seganygaussians_torch.seg import language as tl
from seganygaussians_torch.seg.scale_gate import ScaleGateParams as TGate

TOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def gate_pair(rng, d=32):
    w = rng.normal(0, 0.5, (1, d)).astype(np.float32)
    b = rng.normal(1.5, 0.5, (d,)).astype(np.float32)
    return JGate(jnp.asarray(w), jnp.asarray(b)), TGate(t(w), t(b))


def blob_masks(rng, k, h, w):
    """k seeded discs and boxes of mixed size, as float {0, 1} masks."""
    ys, xs = np.mgrid[:h, :w]
    out = []
    for i in range(k):
        cx, cy, r = rng.uniform(0, w), rng.uniform(0, h), rng.uniform(0.1, 0.45) * min(h, w)
        m = ((xs - cx) ** 2 + (ys - cy) ** 2 < r * r) if i % 2 else (
            (np.abs(xs - cx) < r) & (np.abs(ys - cy) < 0.7 * r))
        out.append(m)
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("factor", [1, 2, 4, 2.6, 0.5])
def test_resize_matches_jax_image_resize(factor):
    """The port's resize is ``jax.image.resize(..., "bilinear")``: plain
    bilinear when it enlarges, a triangle filter widened by the factor when
    it shrinks; 1e-6, on mask stacks and on a feature map's channels."""
    rng = np.random.default_rng(1)
    h, w = 52, 84
    oh, ow = int(h / factor), int(w / factor)
    masks = blob_masks(rng, 4, h, w)
    want = np.asarray(jax.image.resize(jnp.asarray(masks), (4, oh, ow), "bilinear"))
    got = tl.resize_bilinear(t(masks), (oh, ow)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)

    fmap = rng.normal(size=(h, w, 32)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(fmap), (oh, ow, 32), "bilinear"))
    got = tl.resize_bilinear(t(fmap).permute(2, 0, 1), (oh, ow)).permute(1, 2, 0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if factor > 1:  # without the widened filter the numbers are others
        plain = torch.nn.functional.interpolate(t(masks)[None], size=(oh, ow), mode="bilinear",
                                                align_corners=False)[0].numpy()
        want_m = np.asarray(jax.image.resize(jnp.asarray(masks), (4, oh, ow), "bilinear"))
        assert np.abs(plain - want_m).max() > 1e-2


@pytest.mark.parametrize("out_hw", [(60, 80), (15, 20), (23, 31)])
def test_erode_masks_matches_jax(out_hw):
    """Downsample, 3×3 window sum over a zero border, ≥ 2: equal masks
    wherever the window sum lies more than 1e-5 from 2."""
    rng = np.random.default_rng(2)
    masks = blob_masks(rng, 6, 60, 80)
    want = np.asarray(jl.erode_masks(jnp.asarray(masks), out_hw))
    got = tl.erode_masks(t(masks), out_hw).numpy()
    small = jax.image.resize(jnp.asarray(masks), (6,) + out_hw, "bilinear")
    window = np.asarray(jax.lax.reduce_window(small, 0.0, jax.lax.add, (1, 3, 3), (1, 1, 1),
                                              "SAME"))
    np.testing.assert_allclose(box_sum_3x3(tl.resize_bilinear(t(masks), out_hw)).numpy(),
                               window, atol=1e-5, rtol=0)
    far = np.abs(window - 2.0) > TOL
    np.testing.assert_array_equal(got[far], want[far])
    assert (~far).sum() <= got.size // 100 + 1
    assert got.dtype == bool and 0 < got.mean() < 1


def test_erosion_keeps_the_interior_only():
    m = np.zeros((1, 8, 8), np.float32)
    m[0, 2:6, 2:6] = 1.0
    out = tl.erode_masks(t(m), (8, 8)).numpy()
    np.testing.assert_array_equal(out, np.asarray(jl.erode_masks(jnp.asarray(m), (8, 8))))
    assert out[0, 3, 3] and not out[0, 0, 0]


def view_inputs(seed, h=40, w=56, k=5, a=60, d=32):
    rng = np.random.default_rng(seed)
    fmap = rng.normal(size=(h, w, d)).astype(np.float32)
    # A smooth map: neighbouring pixels share a direction, as a render's do.
    fmap = np.cumsum(np.cumsum(fmap, 0), 1)
    fmap /= np.linalg.norm(fmap, axis=-1, keepdims=True)
    masks = blob_masks(rng, k, 2 * h, 2 * w)  # at twice the render's resolution
    scales = rng.uniform(0.2, 2.0, k).astype(np.float32)
    anchors = rng.normal(size=(a, d)).astype(np.float32)
    anchors[: a // 2] = fmap[rng.integers(0, h, a // 2), rng.integers(0, w, a // 2)]
    return rng, fmap, masks, scales, anchors


@pytest.mark.parametrize("downsample", [2, 4])
def test_view_mask_statistics_matches_jax(downsample):
    rng, fmap, masks, scales, anchors = view_inputs(3)
    jgate, tgate = gate_pair(rng)
    all_scales = np.concatenate([scales, rng.uniform(0.1, 3.0, 40).astype(np.float32)])
    jqt, tqt = jfit_qt(jnp.asarray(all_scales)), tfit_qt(t(all_scales))
    want = jl.view_mask_statistics(jnp.asarray(fmap), jnp.asarray(masks), jnp.asarray(scales),
                                   jnp.asarray(anchors), jgate, jqt, downsample=downsample)
    got = tl.view_mask_statistics(t(fmap), t(masks), t(scales), t(anchors), tgate, tqt,
                                  downsample=downsample)
    mf = np.asarray(want.mask_features)
    np.testing.assert_allclose(got.mask_features.numpy(), mf, atol=TOL, rtol=0)
    # The identifiers' scores, from the JAX package's own pieces.
    g = np.asarray(japply_gate(jgate, japply_qt(jqt, jnp.asarray(scales)).reshape(-1, 1)))
    ga = g[:, None, :] * anchors[None]
    ga /= np.linalg.norm(ga, axis=-1, keepdims=True).clip(1e-9)
    score = np.einsum("kac,kc->ka", ga, mf)
    ids_j = np.asarray(want.identifiers)
    far = np.abs(score - 0.5) > TOL
    np.testing.assert_array_equal(got.identifiers.numpy()[far], ids_j[far])
    assert (~far).sum() <= 2
    assert 0 < ids_j.mean() < 1


def test_mask_iou_distance_and_clustering_match_jax():
    rng = np.random.default_rng(4)
    base = rng.uniform(size=(4, 200)) < 0.3
    ids = base[rng.integers(0, 4, 40)] ^ (rng.uniform(size=(40, 200)) < 0.03)
    want = np.asarray(jl.mask_iou_distance(jnp.asarray(ids)))
    got = tl.mask_iou_distance(t(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    for eps, min_size in ((0.25, 5), (0.25, 30), (0.1, 2)):
        np.testing.assert_array_equal(tl.cluster_precomputed(got, eps, min_size),
                                      jl.cluster_precomputed(want, eps, min_size))
    labels = tl.cluster_precomputed(got, 0.25, 5)
    assert len(set(labels[labels >= 0])) == 4


def test_select_queries_and_query_similarity_match_jax():
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(12, 8)).astype(np.float32)
    scales = rng.uniform(0.1, 2.0, 12).astype(np.float32)
    scores = rng.uniform(size=12).astype(np.float32)
    for labels in (np.array([0, 0, 1, 1, 1, 2, 2, -1, -1, 0, 1, 2]),  # clusters
                   np.full(12, -1),  # no cluster: the best mask alone
                   np.array([0] * 6 + [1] * 6)):
        for thr in (0.45, 0.99):  # 0.99: no cluster passes, the best one is kept
            fj, sj = jl.select_queries(labels, scores, feats, scales, thr)
            ft, st = tl.select_queries(labels, scores, feats, scales, thr)
            np.testing.assert_array_equal(ft, fj)
            np.testing.assert_array_equal(st, sj)
    ids_j, means_j = jl.score_clusters(scores, labels)
    ids_t, means_t = tl.score_clusters(scores, labels)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_array_equal(means_t, means_j)

    jgate, tgate = gate_pair(rng, d=8)
    jqt, tqt = jfit_qt(jnp.asarray(scales)), tfit_qt(t(scales))
    pts = rng.normal(size=(300, 8)).astype(np.float32)
    q = feats[3] / np.linalg.norm(feats[3])
    want = np.asarray(jl.query_similarity(jnp.asarray(pts), jgate, jqt, jnp.asarray(q),
                                          jnp.asarray(scales[3])))
    got = tl.query_similarity(t(pts), tgate, tqt, t(q), scales[3]).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


class View:
    pass


def text_fixture(seed=6, n=600, d=32, h=32, w=48, n_views=3):
    """Three objects: point features near three directions; per view a
    feature map painting them in three vertical bands, SAM masks of the bands
    (each object's mask in every view), a whole-frame mask and a random blob,
    and 8-dim stand-in CLIP embeddings near the object's axis."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(3, d))
    obj = rng.integers(0, 3, n)
    feats = (dirs[obj] + 0.35 * rng.normal(size=(n, d))).astype(np.float32)
    views = []
    for v in range(n_views):
        order = rng.permutation(3)
        band = np.repeat(order, w // 3 + 1)[:w]  # object id per column
        fmap = dirs[band][None].repeat(h, 0) + 0.3 * rng.normal(size=(h, w, d))
        fmap = (fmap / np.linalg.norm(fmap, axis=-1, keepdims=True)).astype(np.float32)
        masks = [np.broadcast_to(band == o, (h, w)) for o in range(3)]
        masks += [np.ones((h, w), bool), blob_masks(rng, 1, h, w)[0] > 0]
        clip = np.zeros((5, 8), np.float32)
        clip[:3, :3] = np.eye(3)
        clip[3:, 3:5] = np.eye(2)
        view = View()
        view.fmap = fmap
        view.sam_masks = np.stack(masks).astype(bool)
        view.mask_scales = np.array([0.5, 0.6, 0.7, 2.0, 0.3], np.float32) * (1 + 0.05 * v)
        view.clip_features = clip + 0.05 * rng.normal(size=clip.shape).astype(np.float32)
        views.append(view)
    return rng, feats, views, obj


@pytest.mark.parametrize("capacity", [None, 640])
def test_text_segment_with_jax_anchors_matches_jax(capacity):
    """The whole flow with the JAX package's anchors (drawn from its key):
    equal 3D masks, cluster labels, scores and query scales.  The prompt
    scores object 1's CLIP axis."""
    rng, feats, views, obj = text_fixture()
    jgate, tgate = gate_pair(rng)
    all_scales = np.concatenate([v.mask_scales for v in views])
    jqt, tqt = jfit_qt(jnp.asarray(all_scales)), tfit_qt(t(all_scales))
    key = jax.random.PRNGKey(3)
    n, rate = feats.shape[0], 0.05
    anchors = np.asarray(jax.random.choice(key, n, (max(int(round(n * rate)), 8),),
                                           replace=False))
    alive = None
    if capacity:
        alive = np.zeros(capacity, bool)
        alive[:n] = True

    def text_scores(embeds):
        return np.asarray(embeds)[:, 1]

    kw = dict(anchor_rate=rate, min_cluster_size=2, downsample=2)
    want = jl.text_segment(lambda v: jnp.asarray(v.fmap), views, jnp.asarray(feats), jgate,
                           jqt, text_scores, key=key,
                           alive=None if alive is None else jnp.asarray(alive), **kw)
    got = tl.text_segment(lambda v: t(v.fmap), views, t(feats), tgate, tqt, text_scores,
                          anchor_indices=t(anchors),
                          alive=None if alive is None else t(alive), **kw)
    np.testing.assert_array_equal(got.mask3d.numpy(), np.asarray(want.mask3d))
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_allclose(got.scores, want.scores, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got.query_scales, want.query_scales)
    m = got.mask3d.numpy()[:n]
    assert m[obj == 1].mean() > 0.9 and m[obj != 1].mean() < 0.1
    assert got.mask3d.shape[0] == (capacity or n)
    # Drawn with a generator instead: a flow of the same shape.
    res = tl.text_segment(lambda v: t(v.fmap), views, t(feats), tgate, tqt, text_scores,
                          generator=torch.Generator().manual_seed(0), **kw)
    assert res.mask3d.shape == (n,) and len(res.labels) == 5 * len(views)
