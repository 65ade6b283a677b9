"""Plain PyTorch reference of SAGA's affinity-feature layer (Cen et al.,
"Segment Any 3D Gaussians", 2023): K-neighbour and multi-resolution
smoothing, the scale gate,
click similarity, ``segment3d`` and the contrastive loss of one training
step, with the quantile transform of the mask scales.

The contrastive loss and its sampling of scales, ground truth and pairs are
a frozen copy of SAGA's training step as the port states it (one ray block,
one rank).  Its random numbers are drawn here from a generator seeded as the
trainer's, in the trainer's order: they are inputs of the step, not results.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from perfbench.reference import render as rr
from perfbench.reference.arith import Arith

NUM_SAMPLED_SCALES = 8


def safe_normalize(x, eps=1e-12):
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps)


def normalize(x, eps=1e-9):
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(eps)


def smooth(features, smooth_map, cols=None):
    """Mean of the L2-normalised features of each point's neighbours (all K
    columns of the map, or ``cols``)."""
    normed = safe_normalize(features)
    nbrs = smooth_map if cols is None else smooth_map[:, cols]
    return torch.mean(normed[nbrs], dim=1)


def smooth_levels(features, maps):
    """SAGA's multi-resolution smoothing (``smooth_type="multi_res"``): each
    level takes a random subsample of the points and maps every point to its
    K_i nearest subsampled points; the level's value is the mean of the
    L2-normalised features over that map, and the levels are summed.

    Departures from that description: the maps are given (the program builds
    them once, at set-up, and ``map_checks`` holds them to an exact kNN by
    themselves), so the subsamples are the program's draws; the level means
    are summed unweighted (the trainer passes no per-point level weights);
    the normalisation is the program's ``x / max(|x|, 1e-9)``
    (:func:`normalize`)."""
    normed = normalize(features)
    out = torch.zeros_like(normed)
    for nbrs in maps:
        out = out + torch.mean(normed[nbrs], dim=1)
    return out


def smoothing(smooth_type: str, features, maps, cols=None):
    """The configuration's smoothing over ``maps``: ``traditional`` over the
    one K-neighbour map (its columns ``cols``, or all), ``multi_res`` over
    the level maps."""
    if smooth_type == "traditional":
        (smooth_map,) = maps
        return smooth(features, smooth_map, cols)
    if smooth_type == "multi_res":
        return smooth_levels(features, maps)
    raise ValueError(f"no reference for smooth_type {smooth_type!r}")


def gates(w, b, scales):
    """The scale gate sigmoid(s·w + b), (S, D) for S scales."""
    return torch.sigmoid(scales[:, None] * w[0][None, :] + b[None, :])


def gated(features, w, b, scale: float):
    return normalize(features * gates(w, b, torch.tensor([scale], device=features.device))[0])


def feature_map(geom: dict, colors, cam: rr.Camera, ar: Arith):
    """(frame, blend inputs) of the C-channel render, zero background."""
    bg = torch.zeros(colors.shape[1], device=colors.device)
    return rr.render(geom, cam, ar, colors=colors, bg=bg)


def similarity(fmap, prompts, ar: Arith):
    """(H, W) largest cosine of each pixel's normalised feature to the prompts."""
    return ar.einsum("hwc,pc->hwp", normalize(fmap), prompts).amax(dim=-1)


def segment_scores(smoothed, w, b, scale, prompts, ar: Arith):
    """Each Gaussian's largest cosine of its gated feature to the prompts."""
    return ar.mm(gated(smoothed, w, b, scale), normalize(prompts).T).amax(dim=-1)


def segment3d(smoothed, w, b, scale, prompts, ar: Arith, threshold=0.75):
    return segment_scores(smoothed, w, b, scale, prompts, ar) > threshold


# -- the smoothing's neighbour map, exactly, for a sample of rows -----------


def nearest(xyz, rows, k: int, ar: Arith, block: int = 64, margin: int = 16, source=None):
    """The k nearest other points of each of ``rows``, nearest first:
    (indices (R, k), squared distances (R, k)).  Candidates come from
    |x|² + |y|² − 2 x·y, a matrix product as ``torch.cdist`` forms it; the
    k + ``margin`` best of them are ranked again by their differences.  With
    ``source`` (indices into ``xyz``), the k nearest points of ``source``
    instead, the row itself among them where it is one."""
    sq = ar.einsum("nc,nc->n", xyz, xyz)
    pts, sq_pts = (xyz, sq) if source is None else (xyz[source], sq[source])
    m = min(k + margin, pts.shape[0])
    idx, d2 = [], []
    for r0 in range(0, rows.numel(), block):
        r = rows[r0:r0 + block]
        q = xyz[r]
        far = sq[r][:, None] + sq_pts[None, :] - 2.0 * ar.mm(q, pts.T)
        if source is None:
            far[torch.arange(r.numel(), device=xyz.device), r] = float("inf")  # not itself
        cand = torch.topk(far, m, dim=1, largest=False).indices
        del far
        if source is not None:
            cand = source[cand]
        diff = xyz[cand] - q[:, None, :]
        best, col = torch.topk(ar.einsum("rmc,rmc->rm", diff, diff), k, dim=1, largest=False)
        idx.append(torch.gather(cand, 1, col))
        d2.append(best)
    return torch.cat(idx), torch.cat(d2)


def neighbour_misses(xyz, rows, nbrs, kth_d2, itself: bool = False) -> float:
    """Share of the k entries of each row of ``nbrs`` (R, k), the neighbours
    given for ``rows``, that are not among its k nearest other points: farther
    than the k-th nearest's squared distance ``kth_d2`` (R,) beyond a float32
    rounding, the row itself (unless ``itself``: a point among the candidates
    is its own nearest), or a repeat within the row.  IEEE float32."""
    diff = xyz[nbrs] - xyz[rows][:, None, :]
    d2 = torch.sum(diff * diff, dim=-1)
    valid = d2 <= kth_d2[:, None] * (1 + 1e-6)
    if not itself:
        valid = valid & (nbrs != rows[:, None])
    srt = torch.sort(torch.where(valid, nbrs, torch.full_like(nbrs, -1)), dim=1).values
    first = torch.ones_like(valid)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    hits = int(((srt >= 0) & first).sum())
    return 1.0 - hits / nbrs.numel()


# -- the quantile transform of the mask scales (uniform output) ------------


def _unit_linspace(q, device):
    step = torch.tensor(1.0 / (q - 1), dtype=torch.float32, device=device)
    out = torch.arange(q, dtype=torch.float32, device=device) * step
    out[-1] = 1.0
    return out


def fit_quantiles(values, n_quantiles=1000):
    v = torch.sort(values.reshape(-1).float()).values
    n = v.shape[0]
    q = max(2, min(n_quantiles, n))
    pos = _unit_linspace(q, v.device) * (n - 1)
    lo, hi = torch.floor(pos).long(), torch.ceil(pos).long()
    frac = pos - lo
    return v[lo] * (1 - frac) + v[hi] * frac


def quantile_transform(quantiles, x):
    refs = _unit_linspace(quantiles.shape[0], x.device)
    n = quantiles.shape[0]
    i = torch.clamp(torch.searchsorted(quantiles, x, right=True), 1, n - 1)
    dx = quantiles[i] - quantiles[i - 1]
    flat = dx.abs() <= 1.4210855e-14
    f = torch.where(flat, refs[i - 1],
                    refs[i - 1] + ((x - quantiles[i - 1]) / torch.where(flat, torch.ones_like(dx), dx))
                    * (refs[i] - refs[i - 1]))
    f = torch.where(x < quantiles[0], refs[0].expand_as(f), f)
    return torch.where(x > quantiles[-1], refs[-1].expand_as(f), f)


# -- one contrastive step ----------------------------------------------------


class Masks(NamedTuple):
    masks: torch.Tensor  # (K, H, W) float, by descending scale
    scales: torch.Tensor  # (K,) descending
    n: torch.Tensor  # () int64


def sorted_masks(masks_bool, scales) -> Masks:
    order = torch.argsort(-scales)
    return Masks(masks_bool[order].float(), scales[order].float(),
                 torch.tensor(scales.shape[0], device=scales.device))


class Draws(NamedTuple):
    ray_idx: torch.Tensor
    rand_idx: torch.Tensor
    u0: torch.Tensor
    u_jitter: torch.Tensor
    pair_rand: torch.Tensor
    cols: Optional[torch.Tensor]


def draw(g: torch.Generator, m: Masks, rays: int, k: int, dropout: float,
         smooth_type: str) -> Draws:
    """One step's random numbers, in the trainer's order: the dropout's
    columns only under ``traditional`` smoothing."""
    def rand(*shape):
        return torch.rand(*shape, generator=g, device=g.device)

    n = m.n.clamp_min(1)
    rand_idx = torch.minimum((rand(NUM_SAMPLED_SCALES) * n).long(), n - 1)
    cols = None
    if smooth_type == "traditional" and 0.0 < dropout < 1.0:
        cols = torch.randperm(k, generator=g, device=g.device)[: int(k * dropout)]
    covered = torch.sum(m.masks.reshape(m.masks.shape[0], -1), dim=0) > 0
    score = rand(covered.shape[0]) - (~covered) * 1e9
    ray_idx = torch.topk(score, rays).indices
    return Draws(ray_idx, rand_idx, rand(()), rand(NUM_SAMPLED_SCALES + 2), rand(rays, rays), cols)


def scales_and_gt(d: Draws, m: Masks, upper, quantiles, ar: Arith):
    k_pad = m.scales.shape[0]
    n = m.n
    dev = m.scales.device
    si = torch.cat([torch.full((1,), -1, dtype=torch.long, device=dev), d.rand_idx.long(),
                    (n - 1)[None]])
    zero = torch.zeros((), device=dev)
    scales = torch.where(si >= 0, m.scales[si.clamp(0, k_pad - 1)], zero)
    scales = torch.cat([(upper + upper * d.u0)[None], scales[1:]])
    masked = torch.where((m.scales < upper) & torch.isfinite(m.scales), m.scales,
                         torch.full_like(m.scales, float("-inf")))
    second_big = torch.max(masked)
    is_upper = scales >= upper
    next_scale = torch.where(si + 1 < n, m.scales[(si + 1).clamp(0, k_pad - 1)], zero)
    is_last = si == n - 1
    delta = torch.where(is_upper, scales - second_big,
                        torch.where(is_last, scales, scales - next_scale))
    scales = scales - delta * d.u_jitter
    flat = m.masks.reshape(k_pad, -1)
    rays_masks = flat[:, d.ray_idx]
    kidx = torch.arange(k_pad, device=dev)[None, :, None]
    si_ = si[:, None, None]
    eligible = (kidx <= si_) & (rays_masks > 0)[None]
    dom = torch.amax(torch.where(eligible, kidx, torch.full_like(kidx, -1)), dim=1)
    low = (kidx == dom[:, None, :]).float()
    high = torch.where((kidx > si_) & (kidx < n), rays_masks[None], zero)
    vec = torch.where(is_upper[:, None, None], (rays_masks * (kidx[0] < n))[None],
                      low * (dom >= 0)[:, None, :] + high)
    corr = ar.einsum("skr,skq->srq", vec, vec)
    return quantile_transform(quantiles, scales), (corr != 0).float()


def pixel_weights(m: Masks, ray_idx, ar: Arith):
    k_pad = m.masks.shape[0]
    flat = m.masks.reshape(k_pad, -1)
    sizes = torch.sum(flat, dim=-1)
    per_pixel = ar.mm(sizes[None, :], flat)[0] / (torch.sum(flat, dim=0) + 1e-9)
    pp = per_pixel[ray_idx]
    ptp = pp[None, :] * pp[:, None]
    ptp_max = torch.max(ptp)
    ptp = torch.where(ptp == 0, torch.full_like(ptp, 1e10), ptp)
    w = torch.clamp_min(ptp_max / ptp, 1.0)
    return (w - torch.min(w)) / (torch.max(w) - torch.min(w) + 1e-12) * 9.0 + 1.0


def contrastive_loss(fmap, w, b, d: Draws, q_scales, gt, ppw, ar: Arith, rfn=1.0):
    """The step's loss of the rendered (H, W, D) map and the gate."""
    dim = fmap.shape[-1]
    rfn_val = torch.mean(torch.sqrt(torch.sum(fmap * fmap, dim=-1) + 1e-12))
    rfn_reg = (1.0 - rfn_val) ** 2
    ray_feats = fmap.reshape(-1, dim)[d.ray_idx]
    g = gates(w, b, q_scales)
    scaled = safe_normalize(ray_feats[None] * g[:, None, :])
    corr = ar.einsum("nhc,njc->nhj", scaled, scaled)
    r = d.ray_idx.shape[0]
    s_total = gt.shape[0]
    with torch.no_grad():
        ids = torch.arange(r, device=fmap.device)
        upper_tri = (ids[:, None] != ids[None, :]) & (ids[:, None] <= ids[None, :])
        sum0 = torch.sum(gt, dim=0)
        cons_neg, cons_pos = sum0 == 0, sum0 == s_total
        inconsistent = ~(cons_neg | cons_pos)
        sampled = inconsistent.sum() / 2.0
        samp_pos = cons_pos & (d.pair_rand < sampled / cons_pos.sum().clamp_min(1))
        samp_neg = cons_neg & (d.pair_rand < sampled / cons_neg.sum().clamp_min(1))
        trig_pos = torch.any((corr < 0.75) & (gt == 1), dim=0)
        trig_neg = torch.any((corr > 0.5) & (gt == 0), dim=0)
        mask_pos = (samp_pos | trig_pos | inconsistent) & upper_tri
        mask_neg = (samp_neg | trig_neg | inconsistent) & upper_tri
    den_p = (mask_pos.sum() * s_total).clamp_min(1)
    den_n = (mask_neg.sum() * s_total).clamp_min(1)
    wp = ppw[None] * gt * corr
    wn = ppw[None] * (1 - gt) * torch.relu(corr)
    return (-torch.sum(wp * mask_pos[None]) / den_p + torch.sum(wn * mask_neg[None]) / den_n
            + rfn * rfn_reg)


def contrastive_grads(features, w, b, smooth_type: str, maps, geom: dict, cam: rr.Camera,
                      m: Masks, d: Draws, upper, quantiles, ar: Arith):
    """(loss, d features, d w, d b) of one step, smoothed as ``smooth_type``
    over ``maps`` (:func:`smoothing`)."""
    with torch.no_grad():
        q_scales, gt = scales_and_gt(d, m, upper, quantiles, ar)
        ppw = pixel_weights(m, d.ray_idx, ar)
    pf = features.detach().requires_grad_(True)
    lw, lb = w.detach().requires_grad_(True), b.detach().requires_grad_(True)
    with torch.enable_grad():
        colors = safe_normalize(smoothing(smooth_type, pf, maps, d.cols))
        frame, (bins, inputs, bg) = feature_map(geom, colors, cam, ar)
        fmap = frame.image.detach().requires_grad_(True)
        loss = contrastive_loss(fmap, lw, lb, d, q_scales, gt, ppw, ar)
        g_map, g_w, g_b = torch.autograd.grad(loss, (fmap, lw, lb))
    g_colors = rr.blend_backward(bins, *inputs, bg, g_map)[3]
    with torch.enable_grad():
        (g_f,) = torch.autograd.grad(colors, pf, g_colors)
    return float(loss.detach()), g_f, g_w, g_b
