"""Language-driven 3D segmentation: SAGA's text-prompt flow.

Counterpart of ``seganygaussians_tpu/seg/language.py`` (the notebook's cells
41-54):

1. ~1 % of the per-Gaussian affinity features become 3D *anchors*.
2. Per training view: render the normalised feature map, downsample it 4×;
   downsample the SAM masks to match and erode them (3×3 box sum ≥ 2); gate
   the map and the anchors by each mask's quantile-transformed scale; pool
   the gated map over each mask → one *mask feature* per mask; its
   *identifier* is the set of anchors whose gated feature matches it
   (cosine > 0.5).
3. Distance between two masks: 1 − Jaccard of their identifiers.
4. Clusters over those distances: connected components of the ε-graph with
   a minimum size (host numpy, in place of HDBSCAN).
5. Every mask's CLIP embedding is scored against the prompt; a cluster scores
   by its members' mean.
6. Clusters scoring > 0.45 (or the best one) give their best member's mask
   feature and scale as queries.
7. Per-Gaussian similarity at each query's scale, > 0.85 → the 3D mask.

``jax.image.resize(..., "bilinear")`` antialiases when it downsamples; the
port's :func:`resize_bilinear` does the same.  Every product here ends in a
threshold and runs in IEEE fp32, whatever the caller's TF32 setting.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from seganygaussians_torch.ops.quantile import QuantileTransform, apply_quantile_transform
from seganygaussians_torch.preprocess import box_sum_3x3
from seganygaussians_torch.seg.queries import normalize, pad_to_alive
from seganygaussians_torch.seg.scale_gate import ScaleGateParams, apply_scale_gate
from seganygaussians_torch.utils.precision import ieee_fp32_matmul


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, (..., h, w), "bilinear")`` for a float (..., H, W)
    tensor: half-pixel centres, and when a side shrinks a triangle filter
    widened by the factor (``antialias=True``), as JAX's default does."""
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    y = F.interpolate(x.reshape(1, -1, h, w), size=tuple(out_hw), mode="bilinear",
                      align_corners=False, antialias=True)
    return y.reshape(*lead, *out_hw)


def erode_masks(masks: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Downsample (K, H, W) masks to ``out_hw`` bilinearly, then keep the
    pixels whose 3×3 box sum is ≥ 2 (the notebook's conv erosion)."""
    small = resize_bilinear(masks.to(torch.float32), out_hw)
    return box_sum_3x3(small) >= 2.0


class ViewMaskStats(NamedTuple):
    mask_features: torch.Tensor  # (K, C) pooled, gated, normalised
    identifiers: torch.Tensor  # (K, A) bool anchor-match vectors


def view_mask_statistics(
    feature_map: torch.Tensor,  # (H, W, C) rendered normalised features
    masks: torch.Tensor,  # (K, h, w) SAM masks (any resolution)
    mask_scales: torch.Tensor,  # (K,) raw 3D scales
    anchors: torch.Tensor,  # (A, C) anchor point features
    gate: ScaleGateParams,
    qt: QuantileTransform,
    downsample: int = 4,
) -> ViewMaskStats:
    """One view's mask features and anchor identifiers."""
    h, w = feature_map.shape[0] // downsample, feature_map.shape[1] // downsample
    fmap = resize_bilinear(feature_map.permute(2, 0, 1), (h, w)).permute(1, 2, 0)  # (h, w, C)
    bin_masks = erode_masks(masks, (h, w)).to(torch.float32)  # (K, h, w)

    q_scales = apply_quantile_transform(qt, mask_scales).reshape(-1, 1)
    gates = apply_scale_gate(gate, q_scales)  # (K, C)

    # normalize(f(p) ⊙ g_k), separately per mask scale, pooled over the
    # mask's pixels.
    gated_map = normalize(fmap[None] * gates[:, None, None, :])  # (K, h, w, C)
    denom = torch.sum(bin_masks, dim=(1, 2))[:, None] + 1e-9
    gated_anchors = normalize(gates[:, None, :] * anchors[None, :, :])  # (K, A, C)
    with ieee_fp32_matmul():
        pooled = torch.einsum("khwc,khw->kc", gated_map, bin_masks) / denom
        mask_features = normalize(pooled)  # (K, C)
        identifiers = torch.einsum("kac,kc->ka", gated_anchors, mask_features) > 0.5
    return ViewMaskStats(mask_features=mask_features, identifiers=identifiers)


def mask_iou_distance(identifiers: torch.Tensor) -> torch.Tensor:
    """(M, M) 1 − Jaccard over anchor bit-vectors."""
    idf = identifiers.to(torch.float32)
    with ieee_fp32_matmul():
        inter = idf @ idf.T  # whole numbers, exact in fp32 below 2^24 anchors
    sizes = torch.sum(idf, dim=-1)
    union = sizes[:, None] + sizes[None, :] - inter
    return 1.0 - inter / (union + 1e-6)


def cluster_precomputed(
    dist: np.ndarray, eps: float = 0.25, min_cluster_size: int = 30
) -> np.ndarray:
    """Deterministic clustering over a precomputed distance matrix:
    connected components of the ε-threshold graph, components smaller than
    ``min_cluster_size`` labelled −1 (noise).  Replaces the reference's
    `HDBSCAN(min_cluster_size=30, cluster_selection_epsilon=0.25,
    metric='precomputed')` (cell 45) — the allowed HDBSCAN substitution."""
    m = dist.shape[0]
    parent = np.arange(m)

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    ii, jj = np.nonzero(dist <= eps)
    for a, b in zip(ii, jj):
        if a < b:
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[rb] = ra
    roots = np.array([find(a) for a in range(m)])
    labels = -np.ones(m, np.int64)
    nxt = 0
    for r in np.unique(roots):
        members = np.nonzero(roots == r)[0]
        if len(members) >= min_cluster_size:
            labels[members] = nxt
            nxt += 1
    return labels


def score_clusters(
    scores: np.ndarray, labels: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Per-cluster mean CLIP score (cell 48).  Returns (cluster_ids,
    cluster_scores) for real clusters (noise −1 excluded)."""
    ids = np.unique(labels)
    ids = ids[ids >= 0]
    means = np.array([scores[labels == c].mean() for c in ids]) if len(ids) else np.zeros(0)
    return ids, means


def select_queries(
    labels: np.ndarray,
    scores: np.ndarray,
    mask_features: np.ndarray,  # (M, C)
    mask_scales: np.ndarray,  # (M,) raw scales
    score_threshold: float = 0.45,
):
    """Good clusters → (query_features (G, C) normalized, query_scales (G,))
    (cells 49-50): each selected cluster contributes its best-scoring
    member's mask feature and that member's raw scale."""
    ids, cluster_scores = score_clusters(scores, labels)
    if len(ids) == 0:
        # No cluster survived min-size: every mask is its own candidate;
        # fall back to the single best-scoring mask.
        best = int(np.argmax(scores))
        f = mask_features[best]
        return (f / max(np.linalg.norm(f), 1e-9))[None], mask_scales[[best]]
    good = ids[cluster_scores > score_threshold]
    if len(good) == 0:
        good = ids[[int(np.argmax(cluster_scores))]]
    feats, scales = [], []
    for g in good:
        members = np.nonzero(labels == g)[0]
        best = members[int(np.argmax(scores[members]))]
        f = mask_features[best]
        feats.append(f / max(np.linalg.norm(f), 1e-9))
        scales.append(mask_scales[best])
    return np.stack(feats), np.asarray(scales)


def query_similarity(
    point_features: torch.Tensor,  # (N, C) raw per-Gaussian features
    gate: ScaleGateParams,
    qt: QuantileTransform,
    query_feature: torch.Tensor,  # (C,) normalised
    raw_scale,  # () raw (un-transformed) scale
) -> torch.Tensor:
    """(N,) per-Gaussian similarity at the query's scale."""
    s = torch.as_tensor(raw_scale, dtype=torch.float32, device=point_features.device)
    q = apply_quantile_transform(qt, s.reshape(1))
    gates = apply_scale_gate(gate, q.reshape(1, 1))[0]  # (C,)
    gated = normalize(point_features * gates[None, :])
    with ieee_fp32_matmul():
        return gated @ query_feature


class TextSegmentResult(NamedTuple):
    mask3d: torch.Tensor  # (N,) bool per-Gaussian
    labels: np.ndarray  # (M,) cluster labels over all masks
    scores: np.ndarray  # (M,) per-mask CLIP scores
    query_scales: np.ndarray  # (G,) selected query scales


def text_segment(
    render_feature_map,  # callable(view) -> (H, W, C) normalised feature map
    views: Sequence,  # objects with .sam_masks / .mask_scales / .clip_features
    point_features: torch.Tensor,  # (N, C)
    gate: ScaleGateParams,
    qt: QuantileTransform,
    text_scores,  # callable(np.ndarray (M, Cc)) -> (M,) CLIP relevancy
    generator: Optional[torch.Generator] = None,
    anchor_rate: float = 0.01,
    threshold: float = 0.85,
    eps: float = 0.25,
    min_cluster_size: int = 30,
    downsample: int = 4,
    alive: Optional[torch.Tensor] = None,
    anchor_indices: Optional[torch.Tensor] = None,
) -> TextSegmentResult:
    """End-to-end language-driven 3D segmentation.  The anchors are
    ``anchor_indices``, or ``max(round(N · anchor_rate), 8)`` rows drawn
    without replacement with ``generator``."""
    n = point_features.shape[0]
    device = point_features.device
    if anchor_indices is None:
        if generator is None:
            raise ValueError("text_segment needs a generator or anchor_indices")
        num_anchors = min(max(int(round(n * anchor_rate)), 8), n)
        anchor_indices = torch.randperm(n, generator=generator, device=generator.device)[:num_anchors]
    anchors = point_features[anchor_indices.to(device)]

    all_feats, all_ids, all_scales, all_clip = [], [], [], []
    for view in views:
        masks = getattr(view, "sam_masks", None)
        scales = getattr(view, "mask_scales", None)
        clip_feats = getattr(view, "clip_features", None)
        if masks is None or scales is None or clip_feats is None:
            continue
        stats = view_mask_statistics(
            render_feature_map(view),
            torch.as_tensor(np.asarray(masks), device=device).to(torch.float32),
            torch.as_tensor(np.asarray(scales), dtype=torch.float32, device=device),
            anchors, gate, qt, downsample=downsample,
        )
        all_feats.append(stats.mask_features)
        all_ids.append(stats.identifiers)
        all_scales.append(np.asarray(scales, np.float32).reshape(-1))
        all_clip.append(np.asarray(clip_feats, np.float32))
    if not all_feats:
        raise ValueError("no view carries sam_masks + mask_scales + clip_features")

    mask_features = torch.cat(all_feats).cpu().numpy()  # (M, C)
    raw_scales = np.concatenate(all_scales)
    clip_embeds = np.concatenate(all_clip)
    clip_embeds = clip_embeds / np.linalg.norm(clip_embeds, axis=-1, keepdims=True).clip(1e-9)

    dist = mask_iou_distance(torch.cat(all_ids)).cpu().numpy()
    labels = cluster_precomputed(dist, eps=eps, min_cluster_size=min_cluster_size)
    scores = np.asarray(text_scores(clip_embeds)).reshape(-1)

    q_feats, q_scales = select_queries(labels, scores, mask_features, raw_scales)
    sim = torch.stack([
        query_similarity(point_features, gate, qt,
                         torch.as_tensor(f, dtype=torch.float32, device=device), s)
        for f, s in zip(q_feats, q_scales)
    ]).amax(dim=0)
    return TextSegmentResult(mask3d=pad_to_alive(sim > threshold, alive), labels=labels,
                             scores=scores, query_scales=q_scales)
