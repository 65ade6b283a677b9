"""Approximate nearest-neighbour distances by Morton-ordered window scans.

Counterpart of ``seganygaussians_tpu/ops/knn.py``: ``mean_sq_dist_to_3nn``
(the ``distCUDA2`` replacement used by ``models/gaussians.py:create_from_points``
for scale initialisation), ``knn_map`` (the K = 16 neighbour map of the
feature smoothing) and ``knn_query_source`` (every point's nearest subsampled
points, for multi-resolution smoothing).  It is the same algorithm, not an
exact KNN, so that its output can be held to the JAX package's:

1. sort points by a 30-bit Morton code of the (rotated) cloud;
2. each sorted position looks at the ±W positions around it and keeps its
   ``keep`` nearest candidates (distances in the original frame);
3. repeat under fixed rotations and merge the candidate sets, dropping
   neighbours found by more than one pass;
4. the k smallest merged distances give the neighbours (3 for the mean).

The rotation matmul is written out elementwise, so it stays full fp32 on the
card whatever the TF32 settings are.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def _fixed_rotations(num: int) -> list[np.ndarray]:
    """Deterministic well-spread orthonormal bases (pass 0 = identity)."""
    rots = [np.eye(3, dtype=np.float32)]
    rng = np.random.default_rng(1234)
    while len(rots) < num:
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        rots.append(q.astype(np.float32))
    return rots


def morton_codes(xyz: torch.Tensor) -> torch.Tensor:
    """30-bit Morton (Z-order) codes from 10-bit quantised coordinates
    (min-max normalised to [0, 1024) per axis, bits interleaved x, y, z)."""
    lo = torch.amin(xyz, dim=0, keepdim=True)
    hi = torch.amax(xyz, dim=0, keepdim=True)
    span = torch.clamp_min(hi - lo, 1e-12)
    q = torch.clamp(((xyz - lo) / span) * 1023.0, 0.0, 1023.0).to(torch.int32)

    def spread(v):
        # Insert two zero bits between each of the 10 bits.
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def _rotate(xyz: torch.Tensor, rot: np.ndarray) -> torch.Tensor:
    """``xyz @ rot.T``, as fp32 products and sums in a fixed order."""
    r = torch.tensor(rot, dtype=torch.float32, device=xyz.device)
    x, y, z = xyz[:, 0:1], xyz[:, 1:2], xyz[:, 2:3]
    return x * r[:, 0] + y * r[:, 1] + z * r[:, 2]


def _window_candidates(
    xyz: torch.Tensor,
    window: int,
    rot: np.ndarray,
    keep: int,
    cand_mask: Optional[torch.Tensor] = None,
    cand_idx: Optional[torch.Tensor] = None,
    sentinel: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One Morton pass → per-point ``keep`` best (d2, idx), original row order.

    Positions past either end of the sorted order, and rows whose
    ``cand_mask`` is False, are +inf with index ``sentinel`` (one past the
    largest real index), so the merge's dedup never collapses a real
    candidate onto them.  ``cand_idx`` is the index reported for each
    candidate row (:func:`knn_query_source` reports source-row ids from a
    combined query + source cloud).

    The ±W window is streamed in groups of 8 shifts into a running sorted
    top-``keep`` per point, so memory stays at (N, keep + 16) however wide the
    window is; a per-pass top-``keep`` loses nothing of the global one."""
    n = xyz.shape[0]
    device = xyz.device
    if cand_idx is None:
        cand_idx = torch.arange(n, device=device)
    if sentinel is None:
        sentinel = n
    order = torch.sort(morton_codes(_rotate(xyz, rot)), stable=True).indices
    xyz_s = xyz[order]
    idx_s0 = cand_idx[order].long()
    mask_s = None if cand_mask is None else cand_mask[order]
    pos = torch.arange(n, device=device)
    inf = torch.full((n,), float("inf"), dtype=torch.float32, device=device)
    junk = torch.full((n,), sentinel, dtype=torch.long, device=device)

    d2_best = inf[:, None].expand(n, keep)
    idx_best = junk[:, None].expand(n, keep)
    group = 8
    for d0 in range(1, window + 1, group):
        d2_rows, idx_rows = [d2_best], [idx_best]
        for d in range(d0, min(d0 + group, window + 1)):
            for s in (1, -1):
                nb = torch.roll(xyz_s, -s * d, dims=0)
                dist = torch.sum((xyz_s - nb) ** 2, dim=-1)
                valid = (pos + s * d >= 0) & (pos + s * d < n)
                if mask_s is not None:
                    valid = valid & torch.roll(mask_s, -s * d)
                d2_rows.append(torch.where(valid, dist, inf)[:, None])
                idx_rows.append(torch.where(valid, torch.roll(idx_s0, -s * d), junk)[:, None])
        d2_cat = torch.cat(d2_rows, dim=1)
        idx_cat = torch.cat(idx_rows, dim=1)
        # Stable, so ties keep the earlier (nearer-shift) candidate.
        d2_sorted, col = torch.sort(d2_cat, dim=1, stable=True)
        d2_best = d2_sorted[:, :keep]
        idx_best = torch.gather(idx_cat, 1, col[:, :keep])
    inv = torch.empty_like(order)
    inv[order] = pos
    return d2_best[inv], idx_best[inv]


def _merged_candidates(xyz, window, num_passes, keep, cand_mask=None, cand_idx=None,
                       sentinel=None):
    keep = min(keep, 2 * window)
    d2s, idxs = zip(*[
        _window_candidates(xyz, window, r, keep, cand_mask=cand_mask, cand_idx=cand_idx,
                           sentinel=sentinel)
        for r in _fixed_rotations(num_passes)
    ])
    d2 = torch.cat(d2s, dim=-1)  # (N, S·keep)
    idx = torch.cat(idxs, dim=-1)
    # Drop neighbours that several passes found: sort each row by index and
    # mask repeats (the same pair always has the same distance).  Masked junk
    # carries the sentinel index and +inf, so it only dedups against itself.
    idx_s, order = torch.sort(idx, dim=-1, stable=True)
    d2_s = torch.gather(d2, -1, order)
    dup = torch.cat(
        [torch.zeros_like(idx_s[:, :1], dtype=torch.bool), idx_s[:, 1:] == idx_s[:, :-1]],
        dim=-1,
    )
    return torch.where(dup, torch.full_like(d2_s, float("inf")), d2_s), idx_s


def mean_sq_dist_to_3nn(
    xyz: torch.Tensor, window: int = 16, num_passes: int = 3
) -> torch.Tensor:
    """Mean squared distance to the 3 nearest neighbours found (``distCUDA2``
    semantics; missing neighbours count as 0, as in the JAX package)."""
    d2, _ = _merged_candidates(xyz, window, num_passes, keep=3)
    top3 = torch.topk(d2, 3, dim=-1, largest=False).values
    return torch.mean(torch.where(torch.isfinite(top3), top3, torch.zeros_like(top3)), dim=-1)


def knn_map(
    xyz: torch.Tensor, k: int, window: Optional[int] = None, num_passes: int = 7
) -> torch.Tensor:
    """(N, k) approximate nearest-neighbour indices (original ordering), self
    excluded: the cached neighbour map of the K = 16 feature smoothing.

    Defaults as in the JAX package: window 4·k (at least 32), 7 rotation
    passes.  The map is computed once and cached by its consumers."""
    if window is None:
        window = max(4 * k, 32)
    d2, idx = _merged_candidates(xyz, window, num_passes, keep=k)
    d2_k, col = torch.topk(d2, k, dim=-1, largest=False, sorted=True)
    nbrs = torch.gather(idx, -1, col)
    # Junk slots (fewer than k real candidates in every window) fall back to
    # self: harmless for smoothing means, and in bounds, unlike the sentinel.
    self_idx = torch.arange(xyz.shape[0], device=xyz.device)[:, None]
    return torch.where(torch.isfinite(d2_k), nbrs, self_idx)


def default_query_source_window(k: int, nq: int, ns: int) -> int:
    """Window for :func:`knn_query_source`: a Morton window of the combined
    cloud holds sources at a share of ``ns / (nq + ns)``, so the width that
    shows each query about 4·k of them is ``2k·(nq + ns)/ns`` a side.  (A
    fixed ``max(8k, 64)`` assumes that share is a half, and runs out of real
    candidates at low sample rates.)"""
    return max(math.ceil(2 * k * (nq + ns) / max(ns, 1)), 64)


def knn_query_source(
    query: torch.Tensor,
    source: torch.Tensor,
    k: int,
    window: Optional[int] = None,
    num_passes: int = 7,
) -> torch.Tensor:
    """(Nq, k) indices into ``source`` of each query's k nearest source points
    (``knn_points(query, source)`` semantics).

    One combined (Nq + Ns) cloud goes through the Morton window scan with the
    query rows masked out of the candidate role; a query that is also in
    ``source`` finds its copy there at distance 0.  The default window
    follows the share of sources in that cloud
    (:func:`default_query_source_window`); an explicit ``window`` is used as
    given."""
    nq, ns = query.shape[0], source.shape[0]
    if window is None:
        window = default_query_source_window(k, nq, ns)
    window = min(window, max(nq + ns - 1, 1))
    device = query.device
    both = torch.cat([query, source], dim=0)
    rows = torch.arange(nq + ns, device=device)
    is_source = rows >= nq
    # Report source-row ids for source rows; query rows are never candidates.
    rep_idx = torch.where(is_source, rows - nq, torch.full_like(rows, ns))
    d2, idx = _merged_candidates(both, window, num_passes, keep=k,
                                 cand_mask=is_source, cand_idx=rep_idx, sentinel=ns)
    d2_k, col = torch.topk(d2, k, dim=-1, largest=False, sorted=True)
    nbrs = torch.gather(idx, -1, col)[:nq]
    finite = torch.isfinite(d2_k)[:nq]
    # Junk slots fall back to the query's best real source neighbour
    # (column 0); a query that found no source at all gets row 0.
    best = torch.where(finite[:, :1], nbrs[:, :1], torch.zeros_like(nbrs[:, :1]))
    return torch.where(finite, nbrs, best)
