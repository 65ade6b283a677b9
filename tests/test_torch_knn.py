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


# --------------------------------------------------------------------------
# The running merge against the all-passes merge it replaced
# --------------------------------------------------------------------------


def _oracle_window_candidates(xyz, window, rot, keep, cand_mask=None, cand_idx=None,
                              sentinel=None):
    """One Morton pass as the all-passes merge ran it: rolled neighbours,
    int64 indices, a running sorted top-``keep`` over groups of 8 shifts."""
    n = xyz.shape[0]
    if cand_idx is None:
        cand_idx = torch.arange(n)
    if sentinel is None:
        sentinel = n
    order = torch.sort(tknn.morton_codes(tknn._rotate(xyz, rot)), stable=True).indices
    xyz_s = xyz[order]
    idx_s0 = cand_idx[order].long()
    mask_s = None if cand_mask is None else cand_mask[order]
    pos = torch.arange(n)
    inf = torch.full((n,), float("inf"))
    junk = torch.full((n,), sentinel, dtype=torch.long)
    d2_best = inf[:, None].expand(n, keep)
    idx_best = junk[:, None].expand(n, keep)
    for d0 in range(1, window + 1, 8):
        d2_rows, idx_rows = [d2_best], [idx_best]
        for d in range(d0, min(d0 + 8, window + 1)):
            for s in (1, -1):
                nb = torch.roll(xyz_s, -s * d, dims=0)
                dist = torch.sum((xyz_s - nb) ** 2, dim=-1)
                valid = (pos + s * d >= 0) & (pos + s * d < n)
                if mask_s is not None:
                    valid = valid & torch.roll(mask_s, -s * d)
                d2_rows.append(torch.where(valid, dist, inf)[:, None])
                idx_rows.append(torch.where(valid, torch.roll(idx_s0, -s * d), junk)[:, None])
        d2_sorted, col = torch.sort(torch.cat(d2_rows, 1), dim=1, stable=True)
        d2_best = d2_sorted[:, :keep]
        idx_best = torch.gather(torch.cat(idx_rows, 1), 1, col[:, :keep])
    inv = torch.empty_like(order)
    inv[order] = pos
    return d2_best[inv], idx_best[inv]


def _oracle_merged(xyz, window, num_passes, keep, **kw):
    """Every pass's list kept, concatenated to (N, S·keep), sorted by index,
    repeats masked +inf; then the k smallest.  Also the count of repeats."""
    keep = min(keep, 2 * window)
    d2s, idxs = zip(*[_oracle_window_candidates(xyz, window, r, keep, **kw)
                      for r in tknn._fixed_rotations(num_passes)])
    d2, idx = torch.cat(d2s, -1), torch.cat(idxs, -1)
    idx_s, order = torch.sort(idx, dim=-1, stable=True)
    d2_s = torch.gather(d2, -1, order)
    dup = torch.cat([torch.zeros_like(idx_s[:, :1], dtype=torch.bool),
                     idx_s[:, 1:] == idx_s[:, :-1]], dim=-1)
    real_dup = dup & torch.isfinite(d2_s)
    return torch.where(dup, torch.full_like(d2_s, float("inf")), d2_s), idx_s, int(real_dup.sum())


def _oracle_top(xyz, window, num_passes, k, **kw):
    d2, idx, repeats = _oracle_merged(xyz, window, num_passes, k, **kw)
    d2_k, col = torch.topk(d2, k, dim=-1, largest=False, sorted=True)
    return d2_k, torch.gather(idx, -1, col), repeats


def _assert_same_lists(d2, idx, d2_want, idx_want):
    """The same distances bitwise, a row's indices equal below its k-th
    distance (an exact tie there may pick another index), and finite entries
    alike."""
    assert torch.equal(d2, d2_want)
    for r in range(d2.shape[0]):
        below = d2[r] < d2[r, -1]
        assert set(idx[r][below].tolist()) == set(idx_want[r][below].tolist()), r
        fin = torch.isfinite(d2[r])
        assert len(set(idx[r][fin].tolist())) == int(fin.sum()), r  # no repeats


@pytest.mark.parametrize("k", [15, 4])
def test_running_merge_gives_the_all_passes_merge_knn_map(k):
    x = torch.from_numpy(clustered_cloud())
    window = max(4 * k, 32)
    d2, idx = tknn._merged_candidates(x, window, 7, keep=k)
    d2_want, idx_want, repeats = _oracle_top(x, window, 7, k)
    assert repeats > 0  # neighbours that several passes found
    assert idx.dtype == torch.int32
    _assert_same_lists(d2, idx, d2_want, idx_want)
    want = torch.where(torch.isfinite(d2_want), idx_want, torch.arange(len(x))[:, None])
    got = tknn.knn_map(x, k)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("rate,window", [(0.1, None), (0.5, None), (0.02, 8)])
def test_running_merge_gives_the_all_passes_merge_query_source(rate, window):
    """With query rows masked out of the candidates, the sentinel one past the
    source rows, and at a sparse rate with a narrow window some rows short of
    k real candidates (junk slots and their fallback)."""
    xyz = clustered_cloud()
    pm, _ = subsample(xyz, rate)
    q, s = torch.from_numpy(xyz), torch.from_numpy(xyz[pm])
    nq, ns, k = len(q), len(s), 4
    w = tknn.default_query_source_window(k, nq, ns) if window is None else window
    both = torch.cat([q, s])
    rows = torch.arange(nq + ns)
    mask = rows >= nq
    rep = torch.where(mask, rows - nq, torch.full_like(rows, ns))
    d2, idx = tknn._merged_candidates(both, w, 7, keep=k, cand_mask=mask, cand_idx=rep,
                                      sentinel=ns)
    d2_want, idx_want, repeats = _oracle_top(both, w, 7, k, cand_mask=mask, cand_idx=rep,
                                             sentinel=ns)
    assert repeats > 0
    _assert_same_lists(d2, idx, d2_want, idx_want)
    short = ~torch.isfinite(d2_want[:nq]).all(-1)
    if window is not None:
        assert short.any()  # junk slots reach the fallback
    assert (idx[~torch.isfinite(d2)] == ns).all()  # junk carries the sentinel
    nbrs, fin = idx_want[:nq], torch.isfinite(d2_want[:nq])
    best = torch.where(fin[:, :1], nbrs[:, :1], torch.zeros_like(nbrs[:, :1]))
    want = torch.where(fin, nbrs, best)
    got = tknn.knn_query_source(q, s, k, window=window)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("kind", ["gaussian", "clustered"])
def test_running_merge_gives_the_all_passes_mean_sq_dist_bitwise(kind):
    x = torch.from_numpy(clouds()[kind])
    top3, _, _ = _oracle_top(x, 16, 3, 3)
    want = torch.mean(torch.where(torch.isfinite(top3), top3, torch.zeros_like(top3)), dim=-1)
    assert torch.equal(tknn.mean_sq_dist_to_3nn(x), want)


def test_merge_holds_two_lists_of_keep_at_most(monkeypatch):
    """Each pass goes into the running list as soon as it is done: the merge
    sees two (N, keep) lists, never more columns, once a pass after the
    first."""
    seen, merge = [], tknn._merge

    def watched(d2_a, idx_a, d2_b, idx_b, sentinel):
        seen.append((tuple(d2_a.shape), tuple(idx_a.shape), tuple(d2_b.shape),
                     tuple(idx_b.shape)))
        out = merge(d2_a, idx_a, d2_b, idx_b, sentinel)
        seen.append((tuple(out[0].shape), tuple(out[1].shape)))
        return out

    monkeypatch.setattr(tknn, "_merge", watched)
    x = torch.from_numpy(clustered_cloud())
    n, k = len(x), 15
    tknn.knn_map(x, k)
    assert seen == [((n, k),) * 4, ((n, k),) * 2] * 6  # 7 passes, 6 merges
