"""SAGA contrastive affinity-feature training.

Counterpart of ``seganygaussians_tpu/train/contrastive_trainer.py``.  One
iteration: pick a camera → sample 8 mask scales + 2 sentinels → sample a
fixed number of rays inside the SAM-mask region → build a per-scale GT
correspondence matrix from the dominant (smallest-scale) mask covering each
ray at that scale → render the 32-dim feature map → scale-gate → pairwise ray
cosine matrix → weighted pos/neg contrastive loss + feature-norm regulariser.

As in the JAX package, shapes are fixed: rays are a top-k of uniform scores
over the mask-covered pixels; with masks sorted by DESCENDING scale, ray r's
GT group at threshold index si is the LARGEST mask index j ≤ si covering r
(one masked max-reduce); mask stacks are padded to ``max_masks`` with zero
masks and −inf scales.

Every random number of a step is drawn up front into a :class:`StepDraws`
(:func:`draw_step`), and :func:`contrastive_step` consumes it, so a caller
can replay another implementation's draws.  On CUDA tensors the feature
render is the hand-written forward-blend kernel at C = 32 and its gradient
the backward-blend kernel (``ops/rasterize.py``, ``backend="auto"``).
Nothing inside a step reads a tensor back to the host except the
rasterizer's instance count.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from seganygaussians_torch.models import feature_gaussians as fgm
from seganygaussians_torch.models import optim
from seganygaussians_torch.ops.camera import CameraParams
from seganygaussians_torch.ops.quantile import (
    QuantileTransform,
    apply_quantile_transform,
    fit_quantile_transform,
)
from seganygaussians_torch.ops.rasterize import RasterConfig, rasterize
from seganygaussians_torch.parallel.mesh import collective, run_alone
from seganygaussians_torch.seg.scale_gate import ScaleGateParams, apply_scale_gate
from seganygaussians_torch.utils import tracing
from seganygaussians_torch.utils.precision import ieee_fp32_matmul

NUM_SAMPLED_SCALES = 8


def _safe_norm(x, dim=-1, keepdim=False, eps=1e-12):
    """sqrt(Σx²+ε): finite gradient at 0 (background pixels are exactly 0)."""
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + eps)


def _safe_normalize(x, dim=-1, eps=1e-12):
    return x * torch.rsqrt(torch.sum(x * x, dim=dim, keepdim=True) + eps)


class MaskBundle(NamedTuple):
    """One camera's padded SAM-mask stack, pre-sorted by descending scale."""

    masks: torch.Tensor  # (K_pad, H, W) float {0, 1}
    scales: torch.Tensor  # (K_pad,) descending; padding = -inf
    n_valid: torch.Tensor  # () int64


def build_mask_bundle(
    sam_masks: np.ndarray, mask_scales: np.ndarray, max_masks: int, device="cuda"
) -> MaskBundle:
    order = np.argsort(-mask_scales)
    m = sam_masks[order].astype(np.float32)
    s = mask_scales[order].astype(np.float32)
    k = len(s)
    if k > max_masks:
        raise ValueError(f"{k} masks > max_masks {max_masks}")
    m = np.pad(m, ((0, max_masks - k), (0, 0), (0, 0)))
    s = np.pad(s, (0, max_masks - k), constant_values=-np.inf)
    with tracing.span("loss"):
        return MaskBundle(
            masks=torch.from_numpy(m).to(device),
            scales=torch.from_numpy(s).to(device),
            n_valid=torch.tensor(k, dtype=torch.long, device=device),
        )


class ContrastiveConsts(NamedTuple):
    upper_bound_scale: torch.Tensor  # () max scale over the whole dataset
    qt: QuantileTransform
    # Per-level neighbour maps when hyper.smooth_type == 'multi_res' (built
    # once by fgm.build_multi_res_maps); () otherwise.
    multi_res_maps: tuple = ()
    # The reverse of each map the smoothing averages over (fgm.reverse_maps),
    # read by the CUDA smoothing kernel's gradient; () builds them at each
    # step (CPU features need none).
    reverse_maps: tuple = ()


class StepDraws(NamedTuple):
    """Every random number one :func:`contrastive_step` uses."""

    ray_idx: torch.Tensor  # (R,) int64 flat pixel indices
    rand_idx: torch.Tensor  # (8,) int64 sampled mask indices in [0, max(n_valid, 1))
    u0: torch.Tensor  # () uniform: how far above the upper bound scale 0 lies
    u_jitter: torch.Tensor  # (10,) uniform per-scale jitter
    pair_rand: torch.Tensor  # (R, R) uniform: which consistent pairs are sampled
    smooth_cols: Optional[torch.Tensor]  # neighbour columns of this step's smoothing


def _ray_sampling(generator: torch.Generator, bundle: MaskBundle, num_rays: int) -> torch.Tensor:
    """A fixed count of rays, uniform over the mask-covered pixels."""
    k_pad = bundle.masks.shape[0]
    covered = torch.sum(bundle.masks.reshape(k_pad, -1), dim=0) > 0
    u = torch.rand(covered.shape[0], generator=generator, device=generator.device)
    score = u.to(covered.device) - (~covered) * 1e9
    return torch.topk(score, num_rays).indices


def draw_step(
    generator: torch.Generator,
    bundle: MaskBundle,
    hyper: "ContrastiveHyper",
    smooth_k: int,
) -> StepDraws:
    """Draw one step's random numbers from ``generator`` (on its device; the
    results are moved to the bundle's)."""
    device = bundle.masks.device

    def rand(*shape):
        return torch.rand(*shape, generator=generator, device=generator.device).to(device)

    r = hyper.num_sampled_rays
    n = bundle.n_valid.clamp_min(1)
    rand_idx = torch.minimum((rand(NUM_SAMPLED_SCALES) * n).long(), n - 1)
    cols = None
    if hyper.smooth_type == "traditional":
        cols = fgm.dropout_columns(generator, smooth_k, hyper.smooth_dropout)
    return StepDraws(
        ray_idx=_ray_sampling(generator, bundle, r),
        rand_idx=rand_idx,
        u0=rand(()),
        u_jitter=rand(NUM_SAMPLED_SCALES + 2),
        pair_rand=rand(r, r),
        smooth_cols=None if cols is None else cols.to(device),
    )


def _sample_scales_and_gt(draws: StepDraws, bundle: MaskBundle, consts):
    """Sampled (jittered, quantile-normalised) scales + per-scale GT corr.

    Returns (q_scales (S,), gt_corrs (S, R, R)) with S = NUM_SAMPLED_SCALES + 2.
    """
    k_pad = bundle.scales.shape[0]
    n = bundle.n_valid
    device = bundle.scales.device

    # index layout: [0] = -1 sentinel (→ above the upper bound), [1:9] =
    # random, [-1] = smallest mask
    si = torch.cat([torch.full((1,), -1, dtype=torch.long, device=device),
                    draws.rand_idx.long(), (n - 1)[None]])  # (S,)

    zero = torch.zeros((), dtype=torch.float32, device=device)
    scales = torch.where(si >= 0, bundle.scales[si.clamp(0, k_pad - 1)], zero)
    upper = consts.upper_bound_scale
    scales = torch.cat([(upper + upper * draws.u0)[None], scales[1:]])

    # second biggest scale, distinct from the upper bound
    masked = torch.where((bundle.scales < upper) & torch.isfinite(bundle.scales),
                         bundle.scales, torch.full_like(bundle.scales, float("-inf")))
    second_big = torch.max(masked)

    # per-scale jitter
    is_upper = scales >= upper
    next_scale = torch.where(si + 1 < n, bundle.scales[(si + 1).clamp(0, k_pad - 1)], zero)
    is_last = si == n - 1
    delta = torch.where(is_upper, scales - second_big,
                        torch.where(is_last, scales, scales - next_scale))
    scales = scales - delta * draws.u_jitter

    # GT correspondence per scale, closed form.
    flat = bundle.masks.reshape(k_pad, -1)
    rays_masks = flat[:, draws.ray_idx]  # (K, R) mask coverage at the sampled rays
    kidx = torch.arange(k_pad, device=device)[None, :, None]  # (1, K, 1)
    si_ = si[:, None, None]  # (S, 1, 1)
    # dominant index: largest j ≤ si covering the ray
    eligible = (kidx <= si_) & (rays_masks > 0)[None]  # (S, K, R)
    dom = torch.amax(torch.where(eligible, kidx, torch.full_like(kidx, -1)), dim=1)  # (S, R)
    gt_vec_low = (kidx == dom[:, None, :]).to(torch.float32)
    gt_vec_high = torch.where((kidx > si_) & (kidx < n), rays_masks[None], zero)
    gt_vec = torch.where(
        is_upper[:, None, None],
        (rays_masks * (kidx[0] < n))[None],
        gt_vec_low * (dom >= 0)[:, None, :] + gt_vec_high,
    )
    with ieee_fp32_matmul():
        corr = torch.einsum("skr,skq->srq", gt_vec, gt_vec)  # (S, R, R)
    gt_corrs = (corr != 0).to(torch.float32)
    q_scales = apply_quantile_transform(consts.qt, scales)
    return q_scales, gt_corrs


def _pixel_weights(bundle: MaskBundle, ray_idx) -> torch.Tensor:
    """Pairwise mask-size weights in [1, 10]."""
    k_pad = bundle.masks.shape[0]
    flat = bundle.masks.reshape(k_pad, -1)
    mask_sizes = torch.sum(flat, dim=-1)  # (K,)
    with ieee_fp32_matmul():
        per_pixel_size = torch.matmul(mask_sizes, flat)  # (P,)
    per_pixel_mean = per_pixel_size / (torch.sum(flat, dim=0) + 1e-9)
    pp = per_pixel_mean[ray_idx]  # (R,)
    ptp = pp[None, :] * pp[:, None]
    ptp_max = torch.max(ptp)
    ptp = torch.where(ptp == 0, torch.full_like(ptp, 1e10), ptp)
    w = torch.clamp_min(ptp_max / ptp, 1.0)
    return (w - torch.min(w)) / (torch.max(w) - torch.min(w) + 1e-12) * 9.0 + 1.0  # (R, R)


@dataclasses.dataclass(frozen=True)
class ContrastiveHyper:
    iterations: int = 10_000
    feature_lr: float = 0.0025
    num_sampled_rays: int = 1000
    smooth_k: int = 16
    smooth_dropout: float = 0.5
    # 'traditional' (the reference trainer's default), 'multi_res', or 'none'
    smooth_type: str = "traditional"
    rfn: float = 1.0
    scale_aware_dim: int = -1
    # Return the raw gradients in aux (tests: Adam's first step is sign(g),
    # so updated parameters say little about the gradient).
    debug_grads: bool = False


def _block_loss(
    point_features: torch.Tensor,
    gate: ScaleGateParams,
    feat_state: fgm.FeatureState,
    camera: CameraParams,
    consts: ContrastiveConsts,
    draws: StepDraws,
    q_scales: torch.Tensor,
    gt_corrs: torch.Tensor,
    ppw: torch.Tensor,
    hyper: ContrastiveHyper,
    config: RasterConfig,
    block: int = 0,
    ray_size: int = 1,
):
    """The loss on ray block ``block`` of ``ray_size`` as a function of the
    two learnable leaves, a generator of its sums over the mesh's "ray" axis
    (``parallel/mesh.py``).

    A block is the rows (S, R/ray, R) of the ray correlations: the whole
    (S, R, R) never exists on a rank.  The pair counts are summed over "ray"
    between the stages, outside the differentiated loss: a collective inside
    the graph would have no gradient.  Returns (the loss to differentiate,
    the block's pair loss, the regulariser, aux).  The regulariser is the
    same on every rank of a camera, so the loss to differentiate carries it
    divided by the ray count and the sum of the ranks' gradients counts it
    once.  At one block the loss to differentiate is the camera's loss."""
    r_total = draws.ray_idx.shape[0]
    if r_total % ray_size:
        raise ValueError(f"{r_total} rays do not split into {ray_size} blocks")
    r_local = r_total // ray_size
    row0 = block * r_local
    rows = slice(row0, row0 + r_local)
    s_total = gt_corrs.shape[0]
    gt_blk, ppw_blk, rand_blk = gt_corrs[:, rows], ppw[rows], draws.pair_rand[rows]
    geom = feat_state.geom
    with ieee_fp32_matmul():
        fs = feat_state._replace(point_features=point_features)
        smoothed = fgm.smooth_features(
            fs, hyper.smooth_type, cols=draws.smooth_cols, maps=consts.multi_res_maps or None,
            reverse=consts.reverse_maps or None,
        )
        # The smoothers L2-normalise before the K-mean; the render normalises
        # each point's feature again, as the reference does.
        feats = _safe_normalize(smoothed)
        with tracing.span("smoothing"):  # models/feature_gaussians.py's activations
            opacity, scales = fgm.get_opacity(geom), fgm.get_scaling(geom)
            rotations = fgm.get_rotation(geom)
        out = rasterize(
            geom.xyz,
            opacity[:, 0],
            camera,
            colors=feats,
            scales=scales,
            rotations=rotations,
            bg=torch.zeros((feats.shape[-1],), dtype=torch.float32, device=feats.device),
            active_mask=geom.alive,
            config=config,
        )
        fmap = out.color  # (H, W, D)
        d = fmap.shape[-1]
        # feature-norm regulariser
        rfn_val = torch.mean(_safe_norm(fmap))
        rfn_reg = (1.0 - rfn_val) ** 2
        ray_feats = fmap.reshape(-1, d)[draws.ray_idx]  # (R, D)
        gates = apply_scale_gate(gate, q_scales[:, None])  # (S, D)
        scaled = _safe_normalize(ray_feats[None, :, :] * gates[:, None, :])  # (S, R, D)
        corr = torch.einsum("nhc,njc->nhj", scaled[:, rows], scaled)  # (S, R/ray, R)

    device = corr.device
    with torch.no_grad():
        row_ids = torch.arange(row0, row0 + r_local, device=device)[:, None]
        col_ids = torch.arange(r_total, device=device)[None, :]
        off_diag_upper = (row_ids != col_ids) & (row_ids <= col_ids)
        sum0 = torch.sum(gt_blk, dim=0)
        cons_neg, cons_pos = sum0 == 0, sum0 == s_total
        inconsistent = ~(cons_neg | cons_pos)
    (counts,) = yield collective(
        "sum", "ray", torch.stack([inconsistent.sum(), cons_pos.sum(), cons_neg.sum()]))
    with torch.no_grad():
        n_inc, n_pos, n_neg = counts
        sampled_num = n_inc / 2.0
        samp_pos = cons_pos & (rand_blk < sampled_num / n_pos.clamp_min(1))
        samp_neg = cons_neg & (rand_blk < sampled_num / n_neg.clamp_min(1))
        trig_pos = torch.any((corr < 0.75) & (gt_blk == 1), dim=0)
        trig_neg = torch.any((corr > 0.5) & (gt_blk == 0), dim=0)
        mask_pos = (samp_pos | trig_pos | inconsistent) & off_diag_upper
        mask_neg = (samp_neg | trig_neg | inconsistent) & off_diag_upper
        is_pos, is_neg = gt_blk == 1, gt_blk == 0
        cos_sums = torch.stack([torch.sum(corr * is_pos), torch.sum(corr * is_neg)])
        cos_counts = torch.stack([torch.sum(is_pos), torch.sum(is_neg)])
    dens, cos_sums, cos_counts = yield collective(
        "sum", "ray", torch.stack([mask_pos.sum(), mask_neg.sum()]), cos_sums, cos_counts)

    with ieee_fp32_matmul():
        den_p, den_n = (dens * s_total).clamp_min(1)
        wp = ppw_blk[None] * gt_blk * corr
        wn = ppw_blk[None] * (1 - gt_blk) * torch.relu(corr)
        pair_loss = (-torch.sum(wp * mask_pos[None]) / den_p
                     + torch.sum(wn * mask_neg[None]) / den_n)
        loss = pair_loss + hyper.rfn * rfn_reg / ray_size
    with torch.no_grad():
        cosine = cos_sums / cos_counts.clamp_min(1)
        aux = {"rfn": rfn_val.detach(), "cosine_pos": cosine[0], "cosine_neg": cosine[1],
               "overflow": out.overflow}
    return loss, pair_loss.detach(), rfn_reg.detach(), aux


def contrastive_loss(
    point_features: torch.Tensor,
    gate: ScaleGateParams,
    feat_state: fgm.FeatureState,
    camera: CameraParams,
    consts: ContrastiveConsts,
    draws: StepDraws,
    q_scales: torch.Tensor,
    gt_corrs: torch.Tensor,
    ppw: torch.Tensor,
    hyper: ContrastiveHyper,
    config: RasterConfig,
):
    """The step's loss and metrics as a function of the two learnable leaves."""
    loss, _, _, aux = run_alone(_block_loss(point_features, gate, feat_state, camera, consts,
                                            draws, q_scales, gt_corrs, ppw, hyper, config))
    return loss, aux


def contrastive_block_step(
    feat_state: fgm.FeatureState,
    gate_params: ScaleGateParams,
    gate_opt: optim.AdamState,
    camera: CameraParams,
    bundle: MaskBundle,
    consts: ContrastiveConsts,
    draws: StepDraws,
    hyper: ContrastiveHyper,
    config: RasterConfig,
    block: int = 0,
    ray_size: int = 1,
):
    """One camera's step on ray block ``block`` of ``ray_size``, a generator
    of its collectives (``parallel/mesh.py``): the loss's sums over "ray",
    then the gradients and the pair loss summed over "ray" and averaged with
    the loss over "data", and the overflow flag maxed.  Returns (feat_state,
    gate_params, gate_opt, aux).  On a mesh of one rank it is
    :func:`contrastive_step`."""
    with torch.no_grad():
        q_scales, gt_corrs = _sample_scales_and_gt(draws, bundle, consts)
        ppw = _pixel_weights(bundle, draws.ray_idx)  # (R, R)

    pf = feat_state.point_features.detach().requires_grad_(True)
    gate = ScaleGateParams(*(x.detach().requires_grad_(True) for x in gate_params))
    loss_for_grad, pair_loss, rfn_reg, aux = yield from _block_loss(
        pf, gate, feat_state, camera, consts, draws, q_scales, gt_corrs, ppw, hyper, config,
        block, ray_size)
    with ieee_fp32_matmul(), tracing.backward("smoothing"):
        feat_grad, *gate_grads = torch.autograd.grad(loss_for_grad, (pf, *gate))
    del loss_for_grad

    feat_grad, *gate_grads, pair_loss = yield collective(
        "sum", "ray", feat_grad, *gate_grads, pair_loss)
    loss = pair_loss + hyper.rfn * rfn_reg
    feat_grad, *gate_grads, loss = yield collective("mean", "data", feat_grad, *gate_grads, loss)
    with tracing.sync("overflow_flag"):
        flag = torch.tensor(int(aux["overflow"]), device=loss.device)
    (overflow,) = yield collective("max", ("data", "ray"), flag)
    gate_grads = ScaleGateParams(*gate_grads)
    with tracing.sync("overflow"):
        overflow = bool(overflow)
    aux.update(loss=loss, overflow=overflow)
    if hyper.debug_grads:
        aux["feat_grads"] = feat_grad
        aux["gate_grads"] = gate_grads

    with torch.no_grad():
        lr = hyper.feature_lr
        new_features, new_opt = optim.adam_update(
            fgm.FeatureParams(feat_grad), feat_state.opt,
            fgm.FeatureParams(feat_state.point_features), fgm.FeatureParams(lr),
        )
        feat_state = feat_state._replace(point_features=new_features.point_features,
                                         opt=new_opt)
        new_gate, new_gate_opt = optim.adam_update(
            gate_grads, gate_opt, gate_params, ScaleGateParams(w=lr, b=lr)
        )
    return feat_state, new_gate, new_gate_opt, aux


def contrastive_step(
    feat_state: fgm.FeatureState,
    gate_params: ScaleGateParams,
    gate_opt: optim.AdamState,
    camera: CameraParams,
    bundle: MaskBundle,
    consts: ContrastiveConsts,
    hyper: ContrastiveHyper,
    config: RasterConfig,
    draws: Optional[StepDraws] = None,
    generator: Optional[torch.Generator] = None,
):
    """One contrastive iteration; returns (feat_state, gate_params, gate_opt,
    aux).  ``draws`` are the step's random numbers; without them they are
    drawn from ``generator``.  The (S, R, R) correlation product and its
    gradient run in IEEE fp32 whatever the caller's TF32 setting."""
    with tracing.span("loss"):
        if draws is None:
            if generator is None:
                raise ValueError("contrastive_step needs draws or a generator")
            draws = draw_step(generator, bundle, hyper, feat_state.smooth_map.shape[1])
        return run_alone(contrastive_block_step(feat_state, gate_params, gate_opt, camera, bundle,
                                                consts, draws, hyper, config))


@dataclasses.dataclass
class ContrastiveTrainer:
    """Host loop over shuffled cameras."""

    feat_state: fgm.FeatureState
    gate_params: ScaleGateParams
    cameras: list  # data.cameras.Camera with sam_masks + mask_scales
    hyper: ContrastiveHyper = ContrastiveHyper()
    config: RasterConfig = RasterConfig()
    seed: int = 0
    # Fires after every iteration, outside its span: on_iteration(self, it, aux).
    on_iteration: Optional[Callable] = None

    def __post_init__(self):
        self.device = self.feat_state.point_features.device
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self.gate_opt = optim.adam_init(self.gate_params)
        # the quantile transform is fitted over ALL cameras' mask scales
        all_scales = np.concatenate(
            [np.asarray(c.mask_scales, np.float32).reshape(-1) for c in self.cameras]
        )
        maps = ()
        if self.hyper.smooth_type == "multi_res":
            maps = fgm.build_multi_res_maps(
                self.feat_state, torch.Generator(device=self.device).manual_seed(self.seed)
            )
        self.consts = ContrastiveConsts(
            upper_bound_scale=torch.tensor(float(all_scales.max()), dtype=torch.float32,
                                           device=self.device),
            qt=fit_quantile_transform(torch.from_numpy(all_scales).to(self.device),
                                      output="uniform"),
            multi_res_maps=maps,
            reverse_maps=fgm.reverse_maps(self.feat_state, self.hyper.smooth_type, maps),
        )
        self.max_masks = max(len(np.asarray(c.mask_scales)) for c in self.cameras)
        self._bundles: dict[int, MaskBundle] = {}
        self._params: dict[int, CameraParams] = {}
        self.metrics_history: list[dict] = []

    def _prep(self, idx: int):
        if idx not in self._bundles:
            cam = self.cameras[idx]
            masks = np.asarray(cam.sam_masks)
            self._bundles[idx] = build_mask_bundle(
                masks, np.asarray(cam.mask_scales), self.max_masks, device=self.device
            )
            # features render at the SAM-mask resolution
            h, w = masks.shape[-2:]
            self._params[idx] = dataclasses.replace(cam.params, width=w, height=h)
        return self._bundles[idx], self._params[idx]

    def run(self, iterations: Optional[int] = None, log_every: int = 0):
        iterations = iterations or self.hyper.iterations
        order_rng = np.random.default_rng(self.seed)
        stack: list[int] = []
        t0 = time.time()
        for it in range(1, iterations + 1):
            with tracing.span("feature_step", uid=it):
                if not stack:
                    stack = list(order_rng.permutation(len(self.cameras)))
                idx = stack.pop()
                bundle, cam_params = self._prep(idx)
                self.feat_state, self.gate_params, self.gate_opt, aux = contrastive_step(
                    self.feat_state, self.gate_params, self.gate_opt, cam_params, bundle,
                    self.consts, self.hyper, self.config, generator=self.generator,
                )
                if aux["overflow"]:
                    raise RuntimeError(
                        f"instance capacity {self.config.capacity} exceeded at iteration {it}; "
                        "raise --raster_capacity"
                    )
            if self.on_iteration:
                self.on_iteration(self, it, aux)
            if log_every and it % log_every == 0:
                m = {k: float(v) for k, v in aux.items() if k not in ("feat_grads", "gate_grads")}
                m["iter"] = it
                m["elapsed_s"] = time.time() - t0
                self.metrics_history.append(m)
        return self.feat_state
