"""Approximate nearest-neighbour distances by Morton-ordered window scans.

Counterpart of ``seganygaussians_tpu/ops/knn.py`` for scale initialisation
only (``mean_sq_dist_to_3nn``, the ``distCUDA2`` replacement used by
``models/gaussians.py:create_from_points``).  It is the same algorithm, not an
exact KNN, so that its output can be held to the JAX package's:

1. sort points by a 30-bit Morton code of the (rotated) cloud;
2. each sorted position looks at the ±W positions around it and keeps its
   ``keep`` nearest candidates (distances in the original frame);
3. repeat under fixed rotations and merge the candidate sets, dropping
   neighbours found by more than one pass;
4. the 3 smallest merged distances give the mean.

The rotation matmul is written out elementwise, so it stays full fp32 on the
card whatever the TF32 settings are.
"""

from __future__ import annotations

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
    xyz: torch.Tensor, window: int, rot: np.ndarray, keep: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """One Morton pass → per-point ``keep`` best (d2, idx), original row order.

    Positions past either end of the sorted order are +inf with index ``n``
    (one past the largest real index), so the merge's dedup never collapses
    a real candidate onto them."""
    n = xyz.shape[0]
    order = torch.sort(morton_codes(_rotate(xyz, rot)), stable=True).indices
    xyz_s = xyz[order]
    pos = torch.arange(n, device=xyz.device)
    d2_rows, idx_rows = [], []
    for d in range(1, window + 1):
        for s in (1, -1):
            nb = torch.roll(xyz_s, -s * d, dims=0)
            nbi = torch.roll(order, -s * d)
            dist = torch.sum((xyz_s - nb) ** 2, dim=-1)
            valid = (pos + s * d >= 0) & (pos + s * d < n)
            d2_rows.append(torch.where(valid, dist, torch.full_like(dist, float("inf"))))
            idx_rows.append(torch.where(valid, nbi, torch.full_like(nbi, n)))
    d2 = torch.stack(d2_rows, dim=1)  # (N, 2W) in sorted order
    idx = torch.stack(idx_rows, dim=1)
    k = min(keep, d2.shape[1])
    d2_best, col = torch.topk(d2, k, dim=1, largest=False, sorted=True)
    idx_best = torch.gather(idx, 1, col)
    inv = torch.empty_like(order)
    inv[order] = pos
    return d2_best[inv], idx_best[inv]


def _merged_candidates(xyz: torch.Tensor, window: int, num_passes: int, keep: int):
    keep = min(keep, 2 * window)
    d2s, idxs = zip(*[_window_candidates(xyz, window, r, keep)
                      for r in _fixed_rotations(num_passes)])
    d2 = torch.cat(d2s, dim=-1)  # (N, S·keep)
    idx = torch.cat(idxs, dim=-1)
    # Drop neighbours that several passes found: sort each row by index and
    # mask repeats (the same pair always has the same distance).
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
