"""32-dim affinity-feature Gaussian model (SAGA's feature field).

Counterpart of ``seganygaussians_tpu/models/feature_gaussians.py``.  Geometry
(xyz/scaling/rotation/opacity) is frozen during contrastive training, so the
state splits into a frozen geometry tuple and one learnable
``point_features`` tensor with its own Adam; no densification here.

Feature smoothing: mean of L2-normalised features over the K nearest
neighbours, self included as column 0 of the Morton-window KNN map.  Dropout
picks one random ⌊K·dropout⌋-subset of neighbour columns per call (the same
subset for every point), like the reference's ``randperm(K)[:K·dropout]``.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch

from seganygaussians_torch.models import optim
from seganygaussians_torch.ops.knn import knn_map, knn_query_source, mean_sq_dist_to_3nn
from seganygaussians_torch.ops.transforms import inverse_sigmoid


class FrozenGeometry(NamedTuple):
    """Non-learnable geometry copied from a trained scene model (log scales,
    pre-sigmoid opacity, activated on use)."""

    xyz: torch.Tensor  # (C, 3)
    scaling: torch.Tensor  # (C, 3) log
    rotation: torch.Tensor  # (C, 4)
    opacity: torch.Tensor  # (C, 1) pre-sigmoid
    alive: torch.Tensor  # (C,) bool


class FeatureParams(NamedTuple):
    """The learnable leaf, as a tuple so that ``optim`` can map over it."""

    point_features: torch.Tensor  # (C, D)


class FeatureState(NamedTuple):
    geom: FrozenGeometry
    point_features: torch.Tensor  # (C, D)
    smooth_map: torch.Tensor  # (C, K) int64 neighbour indices, self at column 0
    opt: Optional[optim.AdamState]  # over FeatureParams; None for an eval-mode load


def get_scaling(geom: FrozenGeometry) -> torch.Tensor:
    return torch.exp(geom.scaling)


def get_opacity(geom: FrozenGeometry) -> torch.Tensor:
    return torch.sigmoid(geom.opacity)


def get_rotation(geom: FrozenGeometry) -> torch.Tensor:
    """Unit quaternions; an all-zero row (a padded slot) stays zero, not NaN."""
    return geom.rotation / torch.linalg.norm(geom.rotation, dim=-1, keepdim=True).clamp_min(1e-12)


def build_smooth_map(xyz: torch.Tensor, k: int = 16) -> torch.Tensor:
    """(C, K) neighbour map with self as column 0 (``knn_points`` on identical
    query and source includes the query point itself)."""
    nbrs = knn_map(xyz, k - 1)
    return torch.cat([torch.arange(xyz.shape[0], device=xyz.device)[:, None], nbrs], dim=-1)


def from_scene_geometry(
    xyz,
    scaling,
    rotation,
    opacity,
    feature_dim: int = 32,
    target: str = "contrastive_feature",
    smooth_k: int = 16,
    seed: int = 0,
    capacity: Optional[int] = None,
    device="cuda",
) -> FeatureState:
    """A feature model on a trained scene's geometry (numpy arrays or
    tensors), which stays frozen; features start as randn·1e-2 (contrastive)
    or zeros (coarse_seg_everything)."""
    n = xyz.shape[0]
    if capacity is None:
        capacity = n
    if n > capacity:
        raise ValueError(f"{n} Gaussians > capacity {capacity}")

    def pad(a):
        a = torch.as_tensor(a, dtype=torch.float32).to(device)
        out = torch.zeros((capacity,) + a.shape[1:], dtype=torch.float32, device=device)
        out[:n] = a
        return out

    rows = torch.arange(capacity, device=device)
    geom = FrozenGeometry(
        xyz=pad(xyz), scaling=pad(scaling), rotation=pad(rotation), opacity=pad(opacity),
        alive=rows < n,
    )
    if target == "contrastive_feature":
        g = torch.Generator().manual_seed(seed)
        feats = (torch.randn(capacity, feature_dim, generator=g) * 1e-2).to(device)
    else:
        feats = torch.zeros((capacity, feature_dim), dtype=torch.float32, device=device)
    # KNN over live geometry only: displace dead (zero-padded) slots far
    # outside the scene so live points near the origin never pick them as
    # neighbours, then map dead rows to self.
    span = geom.xyz.abs().max() + 1.0
    knn_xyz = torch.where(geom.alive[:, None], geom.xyz, geom.xyz + 100.0 * span)
    smooth_map = build_smooth_map(knn_xyz, smooth_k)
    smooth_map = torch.where(geom.alive[:, None], smooth_map, rows[:, None])
    return FeatureState(
        geom=geom,
        point_features=feats,
        smooth_map=smooth_map,
        opt=optim.adam_init(FeatureParams(feats)),
    )


def from_point_cloud(
    points: np.ndarray,
    feature_dim: int = 32,
    smooth_k: int = 16,
    capacity: Optional[int] = None,
    device="cuda",
) -> FeatureState:
    """Fresh geometry from bare points — log-scales from the 3-NN mean squared
    distance, identity quaternions, opacity 0.1 — with zero features (the
    ``init_from_3dgs_pcd`` path: a feature model from a scene PLY's xyz only)."""
    n = points.shape[0]
    xyz = torch.as_tensor(np.asarray(points, np.float32), device=device)
    dist2 = mean_sq_dist_to_3nn(xyz).clamp_min(1e-7)
    scales = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    rots = torch.tensor([1.0, 0.0, 0.0, 0.0], device=device).repeat(n, 1)
    opac = inverse_sigmoid(0.1 * torch.ones((n, 1), dtype=torch.float32, device=device))
    return from_scene_geometry(
        xyz, scales, rots, opac,
        feature_dim=feature_dim, target="feature", smooth_k=smooth_k,
        capacity=capacity, device=device,
    )


def dropout_columns(generator: torch.Generator, k: int, dropout: float) -> Optional[torch.Tensor]:
    """The ⌊K·dropout⌋ neighbour columns one smoothing call averages over, or
    None (all K) when ``dropout`` ∉ (0, 1)."""
    if not 0.0 < dropout < 1.0:
        return None
    return torch.randperm(k, generator=generator, device=generator.device)[: int(k * dropout)]


def smoothed_point_features(
    state: FeatureState,
    cols: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """KNN-smoothed features: L2-normalise, then average over the neighbour
    columns ``cols`` (from :func:`dropout_columns`), or all K if None."""
    # rsqrt(Σx²+ε) form: finite gradient even for all-zero feature rows.
    pf = state.point_features
    normed = pf * torch.rsqrt(torch.sum(pf * pf, dim=-1, keepdim=True) + 1e-12)
    nbrs = state.smooth_map if cols is None else state.smooth_map[:, cols.to(pf.device)]
    return torch.mean(normed[nbrs], dim=1)


def smooth_point_features_inplace(state: FeatureState, smoothed_dim: int = 24) -> FeatureState:
    """Neighbourhood mean of the first ``smoothed_dim`` channels (returns a
    new state; the input's tensor is not modified)."""
    mean = torch.mean(state.point_features[state.smooth_map], dim=1)
    feats = torch.cat([mean[:, :smoothed_dim], state.point_features[:, smoothed_dim:]], dim=-1)
    return state._replace(point_features=feats)


def build_multi_res_maps(
    state: FeatureState,
    generator: torch.Generator,
    sample_rates: Sequence[float] = (0.1, 0.5, 1.5),
    ks: Sequence[int] = (4, 4, 16),
) -> tuple[torch.Tensor, ...]:
    """Per-level neighbour maps for multi-resolution smoothing, built once and
    reused across iterations: level i subsamples the live points at
    ``sample_rates[i]`` and maps every point, queried from its own position,
    to its K_i nearest subsampled points (``knn_points(xyz, xyz[pm])``: a
    selected point finds itself at distance 0, a dropped one smooths over the
    coarse subsample only).  Indices are rows of the full state.

    The subsample is compacted before the search, so the Morton grid spans
    the scene only and every source row is live: ``knn_query_source``'s
    default window then follows the sample rate."""
    xyz = state.geom.xyz
    n = xyz.shape[0]
    maps = []
    for rate, k in zip(sample_rates, ks):
        u = torch.rand(n, generator=generator, device=generator.device).to(xyz.device)
        pm = (u < min(rate, 1.0)) & state.geom.alive
        rows = torch.nonzero(pm).flatten()
        if rows.numel() == 0:
            maps.append(torch.arange(n, device=xyz.device)[:, None].repeat(1, k))
            continue
        idx = knn_query_source(xyz, xyz[rows], k)
        maps.append(rows[idx])
    return tuple(maps)


def multi_res_smoothed_features(
    state: FeatureState,
    maps: Sequence[torch.Tensor],
    smooth_weights: Optional[torch.Tensor] = None,  # (C, L)
) -> torch.Tensor:
    """Sum over levels of (optionally per-point-weighted) K_i-neighbour means
    of the L2-normalised features; differentiable with respect to both
    ``point_features`` and ``smooth_weights``."""
    pf = state.point_features
    normed = pf / torch.linalg.norm(pf, dim=-1, keepdim=True).clamp_min(1e-9)
    out = torch.zeros_like(normed)
    for i, nbrs in enumerate(maps):
        level = torch.mean(normed[nbrs], dim=1)
        out = out + (level if smooth_weights is None else smooth_weights[:, i : i + 1] * level)
    return out


def smooth_features(
    state: FeatureState,
    smooth_type: Optional[str],
    cols: Optional[torch.Tensor] = None,
    maps: Optional[Sequence[torch.Tensor]] = None,
    smooth_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Smoothing dispatch: None/'none' → raw features, 'traditional' → K-NN
    dropout mean over ``cols``, 'multi_res' → per-level subsampled means
    (needs ``maps`` from :func:`build_multi_res_maps`)."""
    if smooth_type in (None, "none"):
        return state.point_features
    if smooth_type == "traditional":
        return smoothed_point_features(state, cols)
    if smooth_type == "multi_res":
        if maps is None:
            raise ValueError("multi_res smoothing needs maps: build_multi_res_maps first")
        return multi_res_smoothed_features(state, maps, smooth_weights)
    raise ValueError(f"unknown smooth_type {smooth_type!r}")


class GridLevels(NamedTuple):
    """Quantised-grid feature levels: level l assigns each point a cell id at
    stride ``strides[l]``; features live in per-cell tables and
    :func:`concat_point_features` gathers and concatenates them with the
    per-point features."""

    idx_mapper: torch.Tensor  # (C, L) int64 compact cell id per point
    tables: tuple[torch.Tensor, ...]  # L tables, (num_cells_l, fd_l)


def init_grid_levels(
    xyz,
    strides: Sequence[float] = (0.05, 0.13, 0.23),
    feature_dims: Sequence[int] = (10, 10, 10),
    device=None,
) -> GridLevels:
    """Quantise xyz per level to a grid, compact the occupied cell ids, and
    allocate a zero feature table per level.  The compaction runs on the host
    once at init (``np.unique`` over the integer (qx, qy, qz) triples, so it
    cannot collide whatever the grid's extent); the map and the tables are
    made on ``device``: by default ``xyz``'s own for a tensor, else ``cuda``."""
    if device is None:
        device = xyz.device if isinstance(xyz, torch.Tensor) else "cuda"
    xyz_np = np.asarray(xyz.detach().cpu() if isinstance(xyz, torch.Tensor) else xyz, np.float64)
    idx_cols, tables = [], []
    for stride, fd in zip(strides, feature_dims):
        q = np.ceil((xyz_np - xyz_np.min(axis=0, keepdims=True)) / stride).astype(np.int64)
        _, compact = np.unique(q, axis=0, return_inverse=True)
        compact = compact.reshape(-1)
        idx_cols.append(torch.from_numpy(compact.astype(np.int64)).to(device))
        tables.append(torch.zeros((int(compact.max()) + 1, fd), dtype=torch.float32,
                                  device=device))
    return GridLevels(idx_mapper=torch.stack(idx_cols, dim=-1), tables=tuple(tables))


def concat_point_features(state: FeatureState, grids: Optional[GridLevels]) -> torch.Tensor:
    """Without grid levels, the per-point features; with them, each level's
    table row (gathered via idx_mapper) concatenated with the per-point
    features."""
    if grids is None:
        return state.point_features
    parts = [table[grids.idx_mapper[:, level]] for level, table in enumerate(grids.tables)]
    return torch.cat(parts + [state.point_features], dim=-1)


def _fields(x) -> Mapping:
    return x._asdict() if hasattr(x, "_asdict") else x


def feature_state_from_jax(fields: Mapping, device="cuda") -> FeatureState:
    """Carry the JAX package's ``FeatureState`` across as numpy arrays.

    ``fields`` maps ``geom`` (a mapping or NamedTuple of xyz, scaling,
    rotation, opacity, alive), ``point_features``, ``smooth_map`` and ``opt``
    (None, or ``mu``/``nu``/``count`` with the moments of ``point_features``)
    to ``np.asarray`` of the JAX state's fields."""
    fields = _fields(fields)
    geom = _fields(fields["geom"])

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    opt = None
    if fields.get("opt") is not None:
        o = _fields(fields["opt"])
        opt = optim.AdamState(mu=FeatureParams(t(o["mu"])), nu=FeatureParams(t(o["nu"])),
                              count=t(o["count"], torch.int32))
    return FeatureState(
        geom=FrozenGeometry(
            xyz=t(geom["xyz"]), scaling=t(geom["scaling"]), rotation=t(geom["rotation"]),
            opacity=t(geom["opacity"]), alive=t(geom["alive"], torch.bool),
        ),
        point_features=t(fields["point_features"]),
        smooth_map=t(fields["smooth_map"], torch.long),
        opt=opt,
    )
