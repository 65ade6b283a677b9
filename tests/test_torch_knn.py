"""Port parity for ops/knn.py: Morton codes, the 3-NN scale-init distance and
the neighbour maps of the feature smoothing (``knn_map``,
``knn_query_source``; further down).

Morton codes must match exactly.  ``mean_sq_dist_to_3nn`` is the same
windowed Morton algorithm as the JAX package's, so it must agree point by
point, not only approximate the exact KNN: 1e-5 relative at ≥ 99 % of the
points (the rotated passes' fp32 products may round a coordinate across a
10-bit quantisation step and move a point in the Morton order), and within
1e-3 on the median.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from seganygaussians_tpu.ops import knn as jknn
from seganygaussians_torch.ops import knn as tknn


def clouds():
    rng = np.random.default_rng(21)
    gauss = rng.normal(scale=0.5, size=(900, 3)).astype(np.float32)
    clustered = np.concatenate([
        rng.normal(loc=c, scale=0.05, size=(150, 3)) for c in rng.uniform(-2, 2, (5, 3))
    ]).astype(np.float32)
    return {"gaussian": gauss, "clustered": clustered}


@pytest.mark.parametrize("kind", ["gaussian", "clustered"])
def test_morton_codes_exact(kind):
    xyz = clouds()[kind]
    want = np.asarray(jknn.morton_codes(jnp.asarray(xyz)))
    got = tknn.morton_codes(torch.from_numpy(xyz)).numpy()
    np.testing.assert_array_equal(got, want)


def test_fixed_rotations_match():
    for a, b in zip(tknn._fixed_rotations(4), jknn._fixed_rotations(4)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["gaussian", "clustered"])
def test_mean_sq_dist_to_3nn_matches_jax(kind):
    xyz = clouds()[kind]
    want = np.asarray(jknn.mean_sq_dist_to_3nn(jnp.asarray(xyz)))
    got = tknn.mean_sq_dist_to_3nn(torch.from_numpy(xyz)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    rel = np.abs(got - want) / np.maximum(want, 1e-12)
    assert np.mean(rel <= 1e-5) >= 0.99, np.sort(rel)[-10:]
    assert np.median(rel) <= 1e-3


# --------------------------------------------------------------------------
# knn_map / knn_query_source (the feature-smoothing neighbour maps)
# --------------------------------------------------------------------------


def clustered_cloud(n_clusters=8, per_cluster=225, background=200, seed=33):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-2, 2, (n_clusters, 3))
    parts = [rng.normal(loc=c, scale=0.08, size=(per_cluster, 3)) for c in centers]
    parts.append(rng.uniform(-2.5, 2.5, (background, 3)))
    return np.concatenate(parts).astype(np.float32)  # (2000, 3)


def assert_same_neighbour_sets(got, want, query, source):
    """Each row holds the same neighbour set; where it does not, the two sets'
    sorted distances agree to 1e-6 relative, i.e. the rows differ only in
    which of several equidistant points they took (``lax.sort`` and
    ``torch.sort`` may order ties differently)."""
    assert got.shape == want.shape
    for r in np.nonzero([set(g) != set(w) for g, w in zip(got, want)])[0]:
        dg = np.sort(((source[got[r]] - query[r]) ** 2).sum(-1))
        dw = np.sort(((source[want[r]] - query[r]) ** 2).sum(-1))
        np.testing.assert_allclose(dg, dw, rtol=1e-6, atol=0, err_msg=f"row {r}")


def test_knn_map_matches_jax():
    xyz = clustered_cloud()
    want = np.asarray(jknn.knn_map(jnp.asarray(xyz), 15))
    got = tknn.knn_map(torch.from_numpy(xyz), 15).numpy()
    assert got.dtype == np.int64 and got.min() >= 0 and got.max() < len(xyz)
    assert_same_neighbour_sets(got, want, xyz, xyz)
    assert not (got == np.arange(len(xyz))[:, None]).any()  # self excluded, no junk


def subsample(xyz, rate, seed=1):
    """(mask, source with the dropped rows displaced far away), the layout
    the JAX package's build_multi_res_maps gives knn_query_source."""
    pm = np.random.default_rng(seed).uniform(size=len(xyz)) < rate
    span = xyz.max() - xyz.min() + 1
    return pm, np.where(pm[:, None], xyz, xyz + 100 * span).astype(np.float32)


def test_knn_query_source_matches_jax_with_explicit_window():
    xyz = clustered_cloud()
    _, src = subsample(xyz, 0.1)
    want = np.asarray(jknn.knn_query_source(jnp.asarray(xyz), jnp.asarray(src), 4, window=64))
    got = tknn.knn_query_source(torch.from_numpy(xyz), torch.from_numpy(src), 4, window=64).numpy()
    assert_same_neighbour_sets(got, want, xyz, src)


def _recall_and_fallbacks(nbrs, xyz, pm, k):
    """``nbrs``: (N, k) rows of the compacted subsample ``xyz[pm]``."""
    d = ((xyz[:, None] - xyz[None, pm]) ** 2).sum(-1)
    exact = np.argsort(d, axis=1)[:, :k]
    recall = np.mean([len(set(a) & set(b)) / k for a, b in zip(nbrs, exact)])
    fallback_rows = np.mean([(r[1:] == r[0]).any() for r in nbrs])
    return recall, fallback_rows


def test_default_query_source_window_follows_the_sample_rate():
    k, n = 4, 2000
    assert tknn.default_query_source_window(k, n, n) == 64  # sources are half the cloud
    assert tknn.default_query_source_window(k, n, 200) == 88
    assert tknn.default_query_source_window(k, n, 60) == 275
    assert tknn.default_query_source_window(16, n, 60) == 1099


@pytest.mark.parametrize("rate", [0.1, 0.03])
def test_knn_query_source_default_window_keeps_recall_at_low_rates(rate):
    """On the compacted subsample ``build_multi_res_maps`` searches, the
    rate-aware default window keeps recall against brute force ≥ 0.95 with no
    row falling back to copies of its column 0, at the reference's sparsest
    level (0.1) and below it.  The JAX package's fixed window ``max(8k, 64)``
    finds fewer neighbours at both rates on this cloud, and at 0.03 drops
    under 0.95 and starts duplicating column 0."""
    k = 4
    xyz = clustered_cloud()
    pm, _ = subsample(xyz, rate)
    x, s = torch.from_numpy(xyz), torch.from_numpy(xyz[pm])
    new = tknn.knn_query_source(x, s, k).numpy()
    recall, fallbacks = _recall_and_fallbacks(new, xyz, pm, k)
    assert recall >= 0.95 and fallbacks == 0.0, (recall, fallbacks)
    old = tknn.knn_query_source(x, s, k, window=max(8 * k, 64)).numpy()
    old_recall, old_fallbacks = _recall_and_fallbacks(old, xyz, pm, k)
    assert old_recall < recall
    if rate == 0.03:
        assert old_recall < 0.95 and old_fallbacks > 0.0, (old_recall, old_fallbacks)
