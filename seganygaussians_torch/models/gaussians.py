"""Gaussian scene model: parameters, serving state and training state.

Counterpart of ``seganygaussians_tpu/models/gaussians.py``.  Parameters live
in a fixed-capacity buffer with an ``alive`` mask (dead slots are culled in
the rasterizer's preprocess, so they cost no tile instances and receive zero
gradients).  Densification clones into dead slots and pruning clears
``alive`` bits, so no tensor changes shape during training.  Parameters are
stored pre-activation: log scales, inverse-sigmoid opacities, unnormalised
quaternions.

A serving state (``from_dense``, a loaded PLY) leaves the training fields
(densification statistics, Adam moments) as ``None``; ``create_from_points``
and ``with_training_fields`` fill them.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from seganygaussians_torch.models import optim
from seganygaussians_torch.ops.knn import mean_sq_dist_to_3nn
from seganygaussians_torch.ops.sh import rgb2sh
from seganygaussians_torch.ops.transforms import (
    build_covariance_3d,
    build_rotation,
    inverse_sigmoid,
)
from seganygaussians_torch.utils import tracing


class GaussianParams(NamedTuple):
    """Per-Gaussian parameters (pre-activation), capacity-padded."""

    xyz: torch.Tensor  # (C, 3)
    features_dc: torch.Tensor  # (C, 1, 3)
    features_rest: torch.Tensor  # (C, (deg+1)^2 - 1, 3)
    scaling: torch.Tensor  # (C, 3) log-space
    rotation: torch.Tensor  # (C, 4) unnormalised quats (w, x, y, z)
    opacity: torch.Tensor  # (C, 1) pre-sigmoid


class GaussianState(NamedTuple):
    """Params + liveness + segmentation label; the training fields are None
    on a serving state."""

    params: GaussianParams
    alive: torch.Tensor  # (C,) bool
    seg_mask: torch.Tensor  # (C,) float — the reference's `_mask` label
    max_radii2d: Optional[torch.Tensor] = None  # (C,) float32
    xyz_grad_accum: Optional[torch.Tensor] = None  # (C,) float32
    denom: Optional[torch.Tensor] = None  # (C,) float32
    opt: Optional[optim.AdamState] = None


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    """Optimization hyper-parameters (the 3DGS defaults)."""

    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002


# --------------------------------------------------------------------------
# Activations
# --------------------------------------------------------------------------


def get_scaling(params: GaussianParams) -> torch.Tensor:
    return torch.exp(params.scaling)


def get_opacity(params: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(params.opacity)


def get_rotation(params: GaussianParams) -> torch.Tensor:
    return params.rotation / torch.linalg.norm(
        params.rotation, dim=-1, keepdim=True
    ).clamp_min(1e-12)


def get_covariance(params: GaussianParams, scale_modifier: float = 1.0) -> torch.Tensor:
    """Packed (N, 6) 3D covariances of the activated scales and rotations."""
    return build_covariance_3d(get_scaling(params), get_rotation(params), scale_modifier)


def get_shs(params: GaussianParams) -> torch.Tensor:
    """(C, 3, n_coeff) SH layout consumed by eval_sh (channels first)."""
    return torch.cat([params.features_dc, params.features_rest], dim=1).transpose(1, 2)


def num_alive(state: GaussianState) -> torch.Tensor:
    return torch.sum(state.alive.to(torch.int32))


# --------------------------------------------------------------------------
# Construction
# --------------------------------------------------------------------------


def with_training_fields(state: GaussianState) -> GaussianState:
    """Zero densification statistics and fresh Adam moments."""
    zeros = torch.zeros_like(state.alive, dtype=torch.float32)
    return state._replace(
        max_radii2d=zeros,
        xyz_grad_accum=zeros.clone(),
        denom=zeros.clone(),
        opt=optim.adam_init(state.params),
    )


def create_from_points(
    points: np.ndarray,  # (N, 3)
    colors: np.ndarray,  # (N, 3) in [0, 1]
    sh_degree: int,
    capacity: int,
    device="cuda",
) -> GaussianState:
    """Initialise from an SfM point cloud: DC SH from RGB, log-scale from
    sqrt(mean 3-NN squared distance), identity quaternions, opacity 0.1."""
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"{n} points > capacity {capacity}")
    rest = (sh_degree + 1) ** 2 - 1

    xyz = torch.as_tensor(np.asarray(points, np.float32), device=device)
    dist2 = torch.clamp_min(mean_sq_dist_to_3nn(xyz), 1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)

    def pad(a, fill=0.0):
        out = torch.full((capacity,) + tuple(a.shape[1:]), fill, dtype=torch.float32,
                         device=device)
        out[:n] = a
        return out

    rgb = torch.as_tensor(np.asarray(colors, np.float32), device=device)
    params = GaussianParams(
        xyz=pad(xyz),
        features_dc=pad(rgb2sh(rgb)[:, None, :]),
        features_rest=torch.zeros((capacity, rest, 3), dtype=torch.float32, device=device),
        scaling=pad(scales),
        rotation=pad(
            torch.tensor([1.0, 0.0, 0.0, 0.0], device=device).repeat(n, 1), fill=1.0
        ),
        opacity=pad(inverse_sigmoid(0.1 * torch.ones((n, 1), device=device))),
    )
    alive = torch.arange(capacity, device=device) < n
    return with_training_fields(
        GaussianState(params=params, alive=alive, seg_mask=alive.to(torch.float32))
    )


def make_lr_tree(h: TrainHyper, spatial_lr_scale: float, step: int) -> GaussianParams:
    """Per-group learning rates for ``optim.adam_update`` at ``step``."""
    xyz_lr = optim.expon_lr(
        step,
        h.position_lr_init * spatial_lr_scale,
        h.position_lr_final * spatial_lr_scale,
        lr_delay_mult=h.position_lr_delay_mult,
        max_steps=h.position_lr_max_steps,
    )
    return GaussianParams(
        xyz=xyz_lr,
        features_dc=h.feature_lr,
        features_rest=h.feature_lr / 20.0,
        scaling=h.scaling_lr,
        rotation=h.rotation_lr,
        opacity=h.opacity_lr,
    )


# --------------------------------------------------------------------------
# Densification (fixed shapes)
# --------------------------------------------------------------------------


def add_densification_stats(
    state: GaussianState,
    ndc_grad: torch.Tensor,  # (C, 2) gradient w.r.t. the NDC offset
    radii: torch.Tensor,  # (C,) int32 from the rasterizer
) -> GaussianState:
    """Accumulate view-space positional gradient norms of visible Gaussians
    and their running maximum screen radius."""
    visible = radii > 0
    gnorm = torch.linalg.norm(ndc_grad, dim=-1)
    return state._replace(
        xyz_grad_accum=state.xyz_grad_accum + torch.where(visible, gnorm, 0.0),
        denom=state.denom + visible.to(torch.float32),
        max_radii2d=torch.where(
            visible,
            torch.maximum(state.max_radii2d, radii.to(torch.float32)),
            state.max_radii2d,
        ),
    )


def _scatter_clones(
    params: GaussianParams,
    opt: optim.AdamState,
    alive: torch.Tensor,
    sel: torch.Tensor,  # (C,) bool source rows
    new_rows: GaussianParams,  # (C, ...) values aligned with source rows
    copy_index: int,
) -> tuple[GaussianParams, optim.AdamState, torch.Tensor]:
    """Write ``new_rows[sel]`` into dead slots (copy ``copy_index`` of the
    selection).  Writes beyond the pool of dead slots are dropped."""
    c = alive.shape[0]
    dead_idx = torch.sort(alive.to(torch.int8), stable=True).indices  # dead first
    num_dead = c - int(alive.sum())
    sel_rank = torch.cumsum(sel.to(torch.int64), 0) - 1
    slot_rank = copy_index * int(sel.sum()) + sel_rank
    ok = sel & (slot_rank < num_dead)
    src = torch.nonzero(ok).flatten()
    dest = dead_idx[slot_rank[src]]

    def scat(buf, rows):
        out = buf.clone()
        out[dest] = rows[src]
        return out

    def zero(buf):
        out = buf.clone()
        out[dest] = 0.0
        return out

    new_params = GaussianParams(*(scat(b, r) for b, r in zip(params, new_rows)))
    # Fresh rows get zero moments.
    new_opt = optim.AdamState(
        mu=GaussianParams(*(zero(m) for m in opt.mu)),
        nu=GaussianParams(*(zero(v) for v in opt.nu)),
        count=opt.count,
    )
    new_alive = alive.clone()
    new_alive[dest] = True
    return new_params, new_opt, new_alive


def split_normals(generator: torch.Generator, shape, device) -> list[torch.Tensor]:
    """The two standard-normal draws of a split, one per new copy."""
    return [torch.randn(shape, generator=generator, device=device) for _ in range(2)]


def densify_and_prune(
    state: GaussianState,
    generator: torch.Generator,
    max_grad: float,
    min_opacity: float,
    extent: float,
    max_screen_size: float,
    percent_dense: float = 0.01,
) -> GaussianState:
    """Clone + split + prune, shapes unchanged.

    clone: avg grad ≥ thresh ∧ max scale ≤ percent_dense·extent → duplicate.
    split: avg grad ≥ thresh ∧ max scale >  percent_dense·extent → two samples
           from N(mean, Σ) with scale /(0.8·2); original pruned.
    prune: opacity < min ∨ screen radius > max_screen ∨ scale > 0.1·extent.
    """
    params, alive = state.params, state.alive
    grads = state.xyz_grad_accum / torch.clamp_min(state.denom, 1.0)
    grads = torch.where(state.denom > 0, grads, 0.0)
    scaling = get_scaling(params)
    max_scale = torch.amax(scaling, dim=-1)

    hot = (grads >= max_grad) & alive
    clone_sel = hot & (max_scale <= percent_dense * extent)
    split_sel = hot & (max_scale > percent_dense * extent)

    # --- clone: exact copies into dead slots.
    params, opt, alive = _scatter_clones(params, state.opt, alive, clone_sel, params, 0)

    # --- split: two resampled copies; the parent dies.
    rots = build_rotation(get_rotation(state.params))  # (C, 3, 3)
    new_scaling = torch.log(scaling / (0.8 * 2))
    for i, normals in enumerate(split_normals(generator, state.params.xyz.shape,
                                              state.params.xyz.device)):
        samples = normals * scaling
        new_xyz = torch.sum(rots * samples[:, None, :], dim=-1) + state.params.xyz
        rows = state.params._replace(xyz=new_xyz, scaling=new_scaling)
        params, opt, alive = _scatter_clones(params, opt, alive, split_sel, rows, i)
    alive = alive & ~split_sel

    # --- prune.
    prune = get_opacity(params)[:, 0] < min_opacity
    if max_screen_size:
        prune = prune | (state.max_radii2d > max_screen_size)
        prune = prune | (torch.amax(get_scaling(params), dim=-1) > 0.1 * extent)
    alive = alive & ~prune

    zeros = torch.zeros_like(state.xyz_grad_accum)
    return state._replace(
        params=params, alive=alive, opt=opt,
        xyz_grad_accum=zeros, denom=zeros.clone(), max_radii2d=zeros.clone(),
    )


def reset_opacity(state: GaussianState) -> GaussianState:
    """Clamp opacity to ≤ 0.01 and zero its Adam moments."""
    op = state.params.opacity
    new_op = inverse_sigmoid(torch.minimum(torch.sigmoid(op), torch.full_like(op, 0.01)))
    opt = optim.zero_leaf_rows(state.opt, "opacity", torch.ones_like(state.alive))
    return state._replace(params=state.params._replace(opacity=new_op), opt=opt)


# --------------------------------------------------------------------------
# Segmentation, I/O
# --------------------------------------------------------------------------


def segment(state: GaussianState, mask3d: torch.Tensor) -> GaussianState:
    """Restrict the live set to ``mask3d`` (bool over capacity)."""
    with tracing.span("preprocess"):
        return state._replace(
            alive=state.alive & mask3d,
            seg_mask=torch.where(mask3d, state.seg_mask, torch.zeros_like(state.seg_mask)),
        )


def compact(state: GaussianState) -> dict[str, np.ndarray]:
    """Gather live rows to host numpy arrays (for PLY export)."""
    alive = state.alive.cpu().numpy()
    return {
        name: getattr(state.params, name).detach().cpu().numpy()[alive]
        for name in GaussianParams._fields
    }


def from_dense(
    xyz: np.ndarray,
    features_dc: np.ndarray,
    features_rest: np.ndarray,
    scaling: np.ndarray,
    rotation: np.ndarray,
    opacity: np.ndarray,
    capacity: Optional[int] = None,
    device="cuda",
) -> GaussianState:
    """Build a serving state from dense (N, ...) pre-activation arrays (PLY
    import)."""
    n = xyz.shape[0]
    if capacity is None:
        capacity = n
    if n > capacity:
        raise ValueError(f"{n} Gaussians > capacity {capacity}")

    def pad(a):
        a = np.asarray(a, np.float32)
        out = np.zeros((capacity,) + a.shape[1:], np.float32)
        out[:n] = a
        return torch.from_numpy(out).to(device)

    params = GaussianParams(
        xyz=pad(xyz),
        features_dc=pad(features_dc),
        features_rest=pad(features_rest),
        scaling=pad(scaling),
        rotation=pad(rotation),
        opacity=pad(opacity),
    )
    alive = torch.arange(capacity, device=device) < n
    return GaussianState(params=params, alive=alive, seg_mask=alive.to(torch.float32))


def _fields(x) -> Mapping:
    return x._asdict() if hasattr(x, "_asdict") else x


def from_jax_state(fields: Mapping, device="cuda") -> GaussianState:
    """Carry the JAX package's ``GaussianState`` across as numpy arrays.

    ``fields`` maps ``alive``, ``seg_mask`` and either ``params`` (a mapping
    or NamedTuple of the six parameter arrays) or the six parameter names
    directly to ``np.asarray`` of the JAX state's fields.  When it also holds
    ``max_radii2d``, ``xyz_grad_accum``, ``denom`` and ``opt`` (an
    ``AdamState`` or a mapping with ``mu``, ``nu``, ``count``), the training
    fields come across too.
    """
    fields = _fields(fields)
    params = _fields(fields.get("params", fields))

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    def tree(d):
        d = _fields(d)
        return GaussianParams(**{name: t(d[name]) for name in GaussianParams._fields})

    state = GaussianState(
        params=tree(params),
        alive=t(fields["alive"], torch.bool),
        seg_mask=t(fields["seg_mask"]),
    )
    if fields.get("opt") is None:
        return state
    opt = _fields(fields["opt"])
    return state._replace(
        max_radii2d=t(fields["max_radii2d"]),
        xyz_grad_accum=t(fields["xyz_grad_accum"]),
        denom=t(fields["denom"]),
        opt=optim.AdamState(mu=tree(opt["mu"]), nu=tree(opt["nu"]),
                            count=t(opt["count"], torch.int32)),
    )
