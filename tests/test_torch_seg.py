"""Port parity for seg/queries.py, seg/clustering.py, the scoring math and the
encoder of seg/clip_text.py, and seg/clip_image.py.

The same seeded numpy inputs go through the JAX package and the port on the
CPU.  Similarities, centers and relevancy agree to 1e-5 (float32 products
summed in another order); thresholded outputs are compared exactly wherever
their score lies more than 1e-5 from the threshold.  Where the JAX package
draws with ``jax.random`` (k-means++ centers, subsamples), the test takes the
JAX draws and hands them to the port: torch cannot repeat them.  Singular
vectors are compared up to sign.
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seganygaussians_tpu.seg import clip_image as jimage
from seganygaussians_tpu.seg import clip_text as jclip
from seganygaussians_tpu.seg import clustering as jclust
from seganygaussians_tpu.seg import queries as jq
from seganygaussians_tpu.seg.scale_gate import ScaleGateParams as JGate
from seganygaussians_torch.seg import clip_image as timage
from seganygaussians_torch.seg import clip_text as tclip
from seganygaussians_torch.seg import clustering as tclust
from seganygaussians_torch.seg import queries as tq
from seganygaussians_torch.seg.scale_gate import ScaleGateParams as TGate

TOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def gates(rng, d=32):
    """A gate whose channels differ (0.5-0.95) but keep the blobs apart."""
    w = rng.normal(0, 0.5, (1, d)).astype(np.float32)
    b = rng.normal(1.5, 0.5, (d,)).astype(np.float32)
    return JGate(jnp.asarray(w), jnp.asarray(b)), TGate(t(w), t(b))


def blobs(rng, n=400, d=32, k=5, spread=0.3):
    centers = rng.normal(size=(k, d))
    x = centers[rng.integers(0, k, n)] + spread * rng.normal(size=(n, d))
    return x.astype(np.float32)


def assert_thresholded_equal(got, want, score, threshold, max_near=None):
    """Equal wherever ``score`` lies more than 1e-5 from ``threshold``; the
    rest is counted and must stay under ``max_near`` (default: 1 % + 1)."""
    got, want, score = np.asarray(got), np.asarray(want), np.asarray(score)
    far = np.abs(score - threshold) > TOL
    np.testing.assert_array_equal(got[far], want[far])
    near = int((~far).sum())
    assert near <= (max_near if max_near is not None else got.size // 100 + 1), near


# --------------------------------------------------------------------------
# queries
# --------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [0.0, 0.37, 1.0])
def test_gate_features_and_segment3d_match_jax(scale):
    rng = np.random.default_rng(1)
    feats = blobs(rng)
    jgate, tgate = gates(rng)
    want = np.asarray(jq.gate_features(jnp.asarray(feats), jgate, jnp.asarray(scale)))
    got = tq.gate_features(t(feats), tgate, scale).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)

    prompts = feats[[3, 50, 200]] + 0.1 * rng.normal(size=(3, 32)).astype(np.float32)
    pn = prompts / np.linalg.norm(prompts, axis=-1, keepdims=True)
    sim_j = np.asarray(jq.similarity_to_prompts(jnp.asarray(want), jnp.asarray(pn)))
    sim_t = tq.similarity_to_prompts(t(got), t(pn)).numpy()
    np.testing.assert_allclose(sim_t, sim_j, atol=TOL, rtol=0)

    # A capacity-padded scene state: 400 live rows of 512, two of them dead.
    alive = np.zeros(512, bool)
    alive[:400] = True
    alive[[7, 250]] = False
    for thr in (0.75, 0.85):
        mj = np.asarray(jq.segment3d(jnp.asarray(feats), jgate, jnp.asarray(scale),
                                     jnp.asarray(prompts), threshold=thr,
                                     alive=jnp.asarray(alive)))
        mt = tq.segment3d(t(feats), tgate, scale, t(prompts), threshold=thr,
                          alive=t(alive)).numpy()
        assert mt.shape == (512,) and mj.shape == (512,)
        assert not mt[400:].any() and not mt[[7, 250]].any()
        score = np.concatenate([sim_j, np.full(112, -1.0)])
        assert_thresholded_equal(mt, mj, score, thr)
        assert 0 < mt.sum() < 400
    # Without alive the mask covers the feature rows only.
    assert tq.segment3d(t(feats), tgate, scale, t(prompts)).shape == (400,)


def test_click_similarity_matches_jax():
    rng = np.random.default_rng(2)
    fmap = rng.normal(size=(12, 16, 32)).astype(np.float32)
    fmap /= np.linalg.norm(fmap, axis=-1, keepdims=True)
    want = np.asarray(jq.click_similarity(jnp.asarray(fmap), (5, 9)))
    got = tq.click_similarity(t(fmap), (5, 9)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert got[9, 5] == pytest.approx(1.0, abs=1e-6)


def test_feature_pca_matches_jax_up_to_sign():
    rng = np.random.default_rng(3)
    feats = blobs(rng, n=3000, k=4, spread=0.5)
    key = jax.random.PRNGKey(4)
    sample = 1000
    idx = np.asarray(jax.random.choice(key, feats.shape[0], (sample,), replace=False))
    want = np.asarray(jq.feature_pca(jnp.asarray(feats), key=key, sample=sample))
    got = tq.feature_pca(t(feats), sample=sample, indices=t(idx)).numpy()
    assert got.shape == want.shape == (32, 3)
    sign = np.sign(np.sum(got * want, axis=0))
    np.testing.assert_allclose(got * sign, want, atol=1e-4, rtol=0)

    fmap = rng.normal(size=(6, 8, 32)).astype(np.float32)
    pj = np.asarray(jq.apply_pca(jnp.asarray(fmap), jnp.asarray(want)))
    pt = tq.apply_pca(t(fmap), t(got)).numpy()
    # A flipped axis maps a channel's [0, 1] range onto itself reversed.
    pt = np.where(sign > 0, pt, 1.0 - pt)
    np.testing.assert_allclose(pt, pj, atol=1e-4, rtol=0)
    # Drawn with a generator: a subset of the asked size, a (32, 3) result.
    g = torch.Generator().manual_seed(0)
    assert tq.feature_pca(t(feats), generator=g, sample=sample).shape == (32, 3)


# --------------------------------------------------------------------------
# clustering
# --------------------------------------------------------------------------


def _jax_init(key, x, k, cosine):
    xj = jnp.asarray(x)
    if cosine:
        xj = xj / jnp.linalg.norm(xj, axis=-1, keepdims=True).clip(1e-9)
    return np.asarray(jclust._kmeanspp_init(key, xj, k, cosine))


@pytest.mark.parametrize("cosine", [True, False])
def test_kmeans_matches_jax_from_its_centers(cosine):
    """Lloyd's iterations from the JAX package's own k-means++ centers: equal
    labels, centers and similarities to 1e-5."""
    rng = np.random.default_rng(5)
    x = blobs(rng, n=500, d=16, k=6, spread=0.4)
    key = jax.random.PRNGKey(6)
    k = 6
    want = jclust.kmeans(key, jnp.asarray(x), k, iters=20, cosine=cosine)
    got = tclust.kmeans(t(x), k, iters=20, cosine=cosine,
                        init_centers=t(_jax_init(key, x, k, cosine)))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.centers.numpy(), np.asarray(want.centers), atol=TOL, rtol=0)
    np.testing.assert_allclose(got.similarity.numpy(), np.asarray(want.similarity),
                               atol=TOL * (1 if cosine else 10), rtol=TOL)
    assert got.labels.dtype == torch.int32

    filt_j = jclust.density_filter(want, 0.1)
    filt_t = tclust.density_filter(got, 0.1)
    thresh = float(np.quantile(np.asarray(want.similarity), 0.1))
    noise_j = np.asarray(filt_j.labels) == -1
    assert_thresholded_equal(filt_t.labels.numpy() == -1, noise_j,
                             np.asarray(want.similarity), thresh)
    assert 0.05 < noise_j.mean() <= 0.1


def test_kmeanspp_init_spreads_over_the_blobs():
    """The port's own draw: centers are input rows, one in each of k far-apart
    tight blobs (the chance of a second pick in one blob is ~1e-6)."""
    rng = np.random.default_rng(7)
    centers = 10.0 * np.eye(8, dtype=np.float32)[:4]
    which = rng.integers(0, 4, 400)
    x = (centers[which] + 0.01 * rng.normal(size=(400, 8))).astype(np.float32)
    init = tclust.kmeanspp_init(torch.Generator().manual_seed(3), t(x), 4, cosine=False)
    rows = [int(np.argmin(np.abs(x - c.numpy()).sum(1))) for c in init]
    np.testing.assert_array_equal(x[rows], init.numpy())
    assert sorted(which[rows]) == [0, 1, 2, 3]
    res = tclust.kmeans(t(x), 4, cosine=False, generator=torch.Generator().manual_seed(3))
    assert len(set(res.labels.tolist())) == 4


def test_cluster_features_matches_jax():
    """The GUI recipe with the JAX package's subsample and k-means++ draws."""
    rng = np.random.default_rng(8)
    feats = blobs(rng, n=5000, d=32, k=8, spread=0.3)
    key = jax.random.PRNGKey(9)
    k, rate = 8, 0.05
    want = np.asarray(jclust.cluster_features(key, jnp.asarray(feats), k=k, sample_rate=rate))
    k1, k2 = jax.random.split(key)
    m = max(k, int(feats.shape[0] * rate))
    idx = np.asarray(jax.random.choice(k1, feats.shape[0], (m,), replace=False))
    init = _jax_init(k2, feats[idx], k, True)
    got = tclust.cluster_features(t(feats), k=k, sample_rate=rate, indices=t(idx),
                                  init_centers=t(init)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
    g = torch.Generator().manual_seed(1)
    assert tclust.cluster_features(t(feats), k=k, generator=g).shape == (k, 32)


# --------------------------------------------------------------------------
# clip_text: scoring math and the encoder
# --------------------------------------------------------------------------


def _embeds(rng, n, c=16, norm=True):
    e = rng.normal(size=(n, c)).astype(np.float32)
    return e / np.linalg.norm(e, axis=-1, keepdims=True) if norm else e


def test_relevancy_math_matches_jax():
    rng = np.random.default_rng(10)
    embeds, pos, neg = _embeds(rng, 30, norm=False), _embeds(rng, 3), _embeds(rng, 4)
    J, T = jnp.asarray, t
    for pid in (0, 2):
        np.testing.assert_allclose(
            tclip.get_relevancy(T(embeds), T(pos), T(neg), positive_id=pid).numpy(),
            np.asarray(jclip.get_relevancy(J(embeds), J(pos), J(neg), positive_id=pid)),
            atol=TOL, rtol=0)
    np.testing.assert_allclose(
        tclip.get_relevancy_multi(T(embeds), T(pos), T(neg)).numpy(),
        np.asarray(jclip.get_relevancy_multi(J(embeds), J(pos), J(neg))), atol=TOL, rtol=0)
    raw_pos, raw_neg = 3.0 * pos, 0.5 * neg  # get_scores normalises them itself
    got = tclip.get_scores(T(embeds), T(raw_pos), T(raw_neg)).numpy()
    np.testing.assert_allclose(got, np.asarray(jclip.get_scores(J(embeds), J(raw_pos),
                                                                J(raw_neg))), atol=TOL, rtol=0)
    assert ((got > 0) & (got < 1)).all()
    np.testing.assert_allclose(
        tclip.get_segmentation_scores(T(embeds), T(raw_pos)).numpy(),
        np.asarray(jclip.get_segmentation_scores(J(embeds), J(raw_pos))), atol=TOL, rtol=0)
    masks = (rng.uniform(size=(5, 9, 11)) > 0.5).astype(np.float32)
    scores = rng.uniform(size=5).astype(np.float32)
    np.testing.assert_allclose(
        tclip.scores_to_pixel_map(T(scores), T(masks)).numpy(),
        np.asarray(jclip.scores_to_pixel_map(J(scores), J(masks))), atol=TOL, rtol=0)


def test_template_bank_and_negatives_match_jax():
    assert tclip.DEFAULT_TEMPLATE == jclip.DEFAULT_TEMPLATE
    assert tclip.CANONICAL_NEGATIVES == jclip.CANONICAL_NEGATIVES
    assert all(tpl.count("{}") == 1 for tpl in tclip.DEFAULT_TEMPLATE)


class _DetImpl:
    """A seeded stand-in encoder: a fixed pseudo-embedding per prompt string
    (a digest, not ``hash``, so that it is the same in every process) and a
    per-image embedding from the crop's mean color."""

    dim = 16

    def encode_text(self, prompts):
        import hashlib

        out = []
        for p in prompts:
            seed = int.from_bytes(hashlib.sha256(p.encode()).digest()[:4], "little")
            out.append(np.random.default_rng(seed).normal(size=self.dim))
        return np.asarray(out, np.float32)

    def encode_image(self, images):
        return np.asarray([np.asarray(im, np.float32).mean(axis=(0, 1)).repeat(6)[: self.dim]
                           for im in images], np.float32)


def test_clip_encoder_injected_impl_matches_jax():
    """Template averaging and normalisation through the ``_impl`` seam."""
    je, te = jclip.ClipEncoder(_impl=_DetImpl()), tclip.ClipEncoder(_impl=_DetImpl())
    assert te.backend == "injected"
    texts = ["red chair", "green lamp"]
    np.testing.assert_allclose(te.encode_text_with_template(texts),
                               je.encode_text_with_template(texts), atol=1e-6, rtol=0)
    negs = list(tclip.CANONICAL_NEGATIVES)
    np.testing.assert_allclose(te.encode_text(negs), je.encode_text(negs), atol=1e-6, rtol=0)
    crops = [np.random.default_rng(i).uniform(0, 255, (5 + i, 7, 3)) for i in range(3)]
    np.testing.assert_allclose(te.encode_image(crops), je.encode_image(crops), atol=1e-6, rtol=0)


def _no_clip_packages(monkeypatch):
    """As on a machine without open_clip and transformers: importing either
    raises ImportError (and nothing can reach the network)."""
    monkeypatch.setitem(sys.modules, "open_clip", None)
    monkeypatch.setitem(sys.modules, "transformers", None)


def test_clip_encoder_raises_without_weights(monkeypatch):
    _no_clip_packages(monkeypatch)
    with pytest.raises(RuntimeError, match="CLIP weights unavailable"):
        tclip.ClipEncoder()
    with pytest.raises(RuntimeError, match="OpenCLIP weights unavailable"):
        tclip.ClipEncoder(backend="open_clip")


def test_clip_encoder_warns_when_it_falls_back_to_hf(monkeypatch):
    """The reference falls back to the HF tower silently; the port warns,
    since laion2b sidecars do not match HF embeddings, and says which backend
    it took."""
    class _Hf:
        def __init__(self, name, device="cpu"):
            self.name = name

    monkeypatch.setitem(sys.modules, "open_clip", None)
    monkeypatch.setattr(tclip, "_HfClipImpl", _Hf)
    with pytest.warns(RuntimeWarning, match="HF CLIP tower 'org/tower'"):
        enc = tclip.ClipEncoder(hf_model_name="org/tower")
    assert enc.backend == "hf" and enc._impl.name == "org/tower"
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tclip.ClipEncoder(backend="hf").backend == "hf"  # asked for: no warning


def test_hf_backend_reads_local_files_only(monkeypatch):
    """The HF tower is loaded with ``local_files_only=True``: no download."""
    calls = []

    class _Loader:
        @classmethod
        def from_pretrained(cls, name, **kwargs):
            calls.append((cls.__name__, name, kwargs))
            return types.SimpleNamespace(to=lambda device: "model")

    fake = types.ModuleType("transformers")
    fake.CLIPModel = type("CLIPModel", (_Loader,), {})
    fake.CLIPProcessor = type("CLIPProcessor", (_Loader,), {})
    monkeypatch.setitem(sys.modules, "transformers", fake)
    tclip._HfClipImpl("org/tower")
    assert [c[:2] for c in calls] == [("CLIPModel", "org/tower"), ("CLIPProcessor", "org/tower")]
    assert all(c[2] == {"local_files_only": True} for c in calls)


# --------------------------------------------------------------------------
# clip_image
# --------------------------------------------------------------------------


class _StubEncoder:
    """Records crops; returns a normalised per-crop embedding."""

    dim = 8

    def __init__(self):
        self.crops = []

    def encode_image(self, images):
        self.crops.extend(images)
        out = np.stack([np.full(self.dim, float(np.asarray(im).mean()) + 1.0, np.float32)
                        for im in images])
        return out / np.linalg.norm(out, axis=-1, keepdims=True)


@pytest.mark.parametrize("background", [0.0, 1.0])
def test_mask_clip_features_match_jax(background):
    rng = np.random.default_rng(11)
    img = rng.integers(0, 255, (16, 20, 3), dtype=np.uint8)
    masks = np.zeros((4, 8, 10), np.float32)  # half resolution: upsampled, binarized
    masks[0, 1:3, 2:5] = 1.0
    masks[1, 5:8, 6:10] = 1.0
    masks[3, 0:8, 0:10] = 1.0  # masks[2] stays empty
    je, te = _StubEncoder(), _StubEncoder()
    want = jimage.mask_clip_features(img, masks, je, background=background)
    got = timage.mask_clip_features(img, masks, te, background=background)
    np.testing.assert_array_equal(got, want)
    assert len(te.crops) == 3 and not got[2].any()
    for a, b in zip(te.crops, je.crops):
        np.testing.assert_array_equal(a, b)


def test_extract_scene_clip_features_matches_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(12)
    root = tmp_path / "scene"
    (root / "images").mkdir(parents=True)
    (root / "sam_masks").mkdir()
    for i in range(2):
        img = rng.integers(0, 255, (12, 16, 3), dtype=np.uint8)
        Image.fromarray(img).save(root / "images" / f"v{i}.png")
    Image.fromarray(img).save(root / "images" / "v2.png")  # no sidecar: skipped
    for i in range(2):
        masks = rng.uniform(size=(3, 12, 16)) > 0.6
        torch.save(torch.tensor(masks), root / "sam_masks" / f"v{i}.pt")
    want = jimage.extract_scene_clip_features(str(root), _StubEncoder(), out_dir="want",
                                              log=lambda *a: None)
    got = timage.extract_scene_clip_features(str(root), _StubEncoder(), log=lambda *a: None)
    assert [p.split("/")[-1] for p in got] == ["v0.pt", "v1.pt"]
    for a, b in zip(got, want):
        ta, tb = torch.load(a, weights_only=False), torch.load(b, weights_only=False)
        assert tuple(ta.shape) == (3, 8)
        assert torch.equal(ta, tb)
