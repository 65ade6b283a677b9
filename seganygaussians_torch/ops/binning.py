"""Tile binning: depth sort, instance expansion, (tile, depth) sort.

Counterpart of ``seganygaussians_tpu/ops/binning.py`` and of
``blend_pallas.py:_fused_sort`` (:func:`sort_instances`).

  1. Gaussians are depth-sorted first (an N-sized ``torch.sort``), so the
     instance slots enumerated in Gaussian order are already depth-ordered.
  2. Expansion: slot m belongs to the depth rank g with
     offsets[g] ≤ m < offsets[g] + tiles[g], found by a ``searchsorted`` over
     the inclusive prefix sum of ``tiles_touched``; its tile is decoded from
     the Gaussian's tile rect.
  3. One sort of the int64 key ``tile << 32 | rank``.  (tile, rank) pairs are
     unique, so any sort gives the same order as the JAX package's packed
     int32 key or its 2-key path.
  4. Per-tile [start, end) ranges come from a ``searchsorted`` over the
     sorted keys.

With per-tile-row footprints (``Preprocessed.row_pack``) the expansion has
two levels, Gaussian → tile-row interval → slot (:func:`_expand_slots_rows`).
:func:`plan_instances` replaces steps 3-4 by analytic destinations (the
sort-free plan).  ``capacity`` is the instance budget: slots past it are
dropped and ``overflow`` says so, exactly as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from seganygaussians_torch.ops.projection import Preprocessed
from seganygaussians_torch.utils import tracing
from seganygaussians_torch.utils.precision import ieee_fp32_matmul

_BUCKET_STEPS = (1.0, 1.25, 1.5, 1.75)


def suggest_capacity(total: int, headroom: float = 1.15, multiple: int = 256) -> int:
    """Smallest capacity bucket (2^k · {1, 1.25, 1.5, 1.75}) holding
    ``total`` instances with headroom."""
    need = max(int(total * headroom), multiple)
    k = int(np.floor(np.log2(need)))
    for kk in (k, k + 1):
        base = 1 << kk
        for s in _BUCKET_STEPS:
            cap = int(base * s)
            if cap >= need:
                return ((cap + multiple - 1) // multiple) * multiple
    return ((need + multiple - 1) // multiple) * multiple  # unreachable


class SlotPlan(NamedTuple):
    """Slot-order instance expansion, before the (tile, depth) sort."""

    slot_rank: torch.Tensor  # (M,) int64 ascending depth rank per slot (clipped)
    slot_tile: torch.Tensor  # (M,) int64 tile per slot (== num_tiles ⇒ padding)
    depth_perm: torch.Tensor  # (N,) int64: depth rank → original Gaussian index
    num_instances: int  # true instance count, capped at capacity
    overflow: bool  # capacity exceeded, results truncated


class Binned(NamedTuple):
    """Instances sorted by (tile, depth), as the XLA backend blends them."""

    gauss_id: torch.Tensor  # (M,) int64: sorted instance → depth rank (n = padding)
    tile_id: torch.Tensor  # (M,) int64 sorted tile (== num_tiles ⇒ padding)
    tile_starts: torch.Tensor  # (T+1,) int32; tile t occupies [starts[t], starts[t+1])
    depth_perm: torch.Tensor  # (N,) int64: depth rank → original Gaussian index
    num_instances: int
    overflow: bool


class _DepthOrder(NamedTuple):
    """Gaussians in depth order and their slot ranges (step 1 and the prefix
    sum of step 2)."""

    depth_perm: torch.Tensor  # (N,) int64
    tiles: torch.Tensor  # (N,) int64 tiles touched, by depth rank
    rect_min: torch.Tensor  # (N, 2) int64
    rect_max: torch.Tensor  # (N, 2) int64
    cum: torch.Tensor  # (N,) inclusive prefix sum of tiles
    offsets: torch.Tensor  # (N,) exclusive prefix sum: each rank's first slot
    total: int  # instances wanted


def _depth_order(prep: Preprocessed) -> _DepthOrder:
    n = prep.tiles_touched.shape[0]
    # Culled Gaussians sort last (+inf); stable, like lax.sort_key_val.
    depth_key = torch.where(
        prep.valid, prep.depths.detach(), torch.full_like(prep.depths, float("inf"))
    )
    depth_perm = torch.sort(depth_key, stable=True).indices
    tiles = prep.tiles_touched[depth_perm].to(torch.int64)
    cum = torch.cumsum(tiles, dim=0)
    total = 0
    if n:
        with tracing.sync("binning"):
            total = int(cum[-1])
    return _DepthOrder(
        depth_perm=depth_perm,
        tiles=tiles,
        rect_min=prep.rect_min[depth_perm].to(torch.int64),
        rect_max=prep.rect_max[depth_perm].to(torch.int64),
        cum=cum,
        offsets=cum - tiles,
        total=total,
    )


def _rect_slots(d: _DepthOrder, grid_x: int, capacity: int):
    """Each slot's depth rank, and its tile decoded from the rank's rect
    (past the instances: rank n − 1 and an undefined tile)."""
    n = d.tiles.shape[0]
    slots = torch.arange(capacity, dtype=torch.int64, device=d.tiles.device)
    rank = torch.clamp(torch.searchsorted(d.cum, slots, right=True), 0, max(n - 1, 0))
    rank_local = slots - d.offsets[rank]
    w = torch.clamp_min(d.rect_max[:, 0] - d.rect_min[:, 0], 1)[rank]
    tx = d.rect_min[rank, 0] + rank_local % w
    ty = d.rect_min[rank, 1] + rank_local // w
    return slots, rank, ty * grid_x + tx


def expand_slots(
    prep: Preprocessed, grid_x: int, grid_y: int, capacity: int
) -> SlotPlan:
    """Expand Gaussians into slot-order (rank-grouped) tile instances."""
    num_tiles = grid_x * grid_y
    with tracing.span("binning"):
        d = _depth_order(prep)
        if prep.row_pack is not None:
            plan = _expand_slots_rows(prep, d, grid_x, grid_y, capacity)
        else:
            slots, rank, tile = _rect_slots(d, grid_x, capacity)
            tile = torch.where(slots < d.total, tile, torch.full_like(tile, num_tiles))
            plan = SlotPlan(
                slot_rank=rank,
                slot_tile=torch.clamp(tile, 0, num_tiles),
                depth_perm=d.depth_perm,
                num_instances=min(d.total, capacity),
                overflow=d.total > capacity,
            )
    tracing.count("raster.instances", plan.num_instances)
    tracing.count("raster.capacity", capacity)
    tracing.count("raster.overflows", plan.overflow)
    return plan


def _expand_slots_rows(
    prep: Preprocessed, d: _DepthOrder, grid_x: int, grid_y: int, capacity: int
) -> SlotPlan:
    """Two-level expansion over per-tile-row intervals.

    ``tiles_touched`` counts the intervals' widths, so a slot cannot be
    decoded from one rect: a Gaussian expands to its tile rows (level 1), a
    row to its tiles (level 2), each by a ``searchsorted`` over a prefix sum.
    ``capacity`` also bounds the rows, as in the JAX package, and the
    overflow flag covers both."""
    n = d.tiles.shape[0]
    num_tiles = grid_x * grid_y
    device = d.tiles.device
    row_pack = prep.row_pack[d.depth_perm]  # (N, G) int32
    heights = torch.where(d.tiles > 0, d.rect_max[:, 1] - d.rect_min[:, 1],
                          torch.zeros_like(d.tiles))
    hcum = torch.cumsum(heights, dim=0)
    r_total = 0
    if n:
        with tracing.sync("rows"):
            r_total = int(hcum[-1])

    # Level 1: Gaussian → rows (only those within the budget).
    rows = torch.arange(min(r_total, capacity), dtype=torch.int64, device=device)
    g_r = torch.searchsorted(hcum, rows, right=True)
    ty_r = d.rect_min[g_r, 1] + (rows - (hcum - heights)[g_r])
    flat = g_r * grid_y + ty_r
    rp = row_pack.reshape(-1)[flat].to(torch.int64)
    w_r, x0_r = (rp >> 10) & 1023, rp & 1023
    # The row's first slot: the Gaussian's, plus its earlier rows' widths.
    widths_before = torch.cumsum((row_pack >> 10) & 1023, dim=1, dtype=torch.int32)
    soff_r = d.offsets[g_r] + widths_before.reshape(-1)[flat] - w_r

    # Level 2: row → slots.  Past the kept rows' last slot (the instances
    # and, on overflow, the rows past the budget): padding.
    slots = torch.arange(capacity, dtype=torch.int64, device=device)
    ends = soff_r + w_r
    last = 0
    if rows.shape[0]:
        with tracing.sync("row_slots"):
            last = int(ends[-1])
    row = torch.clamp(torch.searchsorted(ends, slots, right=True), 0, max(rows.shape[0] - 1, 0))
    padding = torch.full_like(slots, num_tiles)
    if rows.shape[0]:
        rank = g_r[row]
        tile = ty_r[row] * grid_x + x0_r[row] + (slots - soff_r[row])
    else:
        rank, tile = torch.zeros_like(slots), padding
    tile = torch.where(slots < min(d.total, last), tile, padding)
    rank = torch.where(slots < d.total, rank, torch.full_like(rank, max(n - 1, 0)))
    return SlotPlan(
        slot_rank=rank,
        slot_tile=torch.clamp(tile, 0, num_tiles),
        depth_perm=d.depth_perm,
        num_instances=min(d.total, capacity),
        overflow=d.total > capacity or r_total > capacity,
    )


def strip_row_footprints(prep: Preprocessed) -> Preprocessed:
    """The rect view of a ``Preprocessed`` that carries row intervals: no
    ``row_pack``, and ``tiles_touched`` counting the whole rect, for the
    consumers that decode a slot from one rect (the sort-free plan, tile
    slabs)."""
    if prep.row_pack is None:
        return prep
    w = torch.clamp_min(prep.rect_max[:, 0] - prep.rect_min[:, 0], 0)
    h = torch.clamp_min(prep.rect_max[:, 1] - prep.rect_min[:, 1], 0)
    touched = torch.where(prep.valid, w * h, torch.zeros_like(w)).to(torch.int32)
    return prep._replace(row_pack=None, tiles_touched=touched)


class InstancePlan(NamedTuple):
    """Sort-free binning: analytic (tile, depth) destinations.

    Slots enumerate depth-ranked Gaussians, so (tile, depth) order is a
    stable partition by tile, and slot i's place in it is closed-form:

        dest[i] = tile_starts[t_i] + #{Gaussians before g_i covering t_i}

    (a Gaussian covers each tile of its rect once).  The count splits into a
    per-block term, cumulative per-tile histograms of blocks of ``block``
    Gaussians (products of separable x/y interval indicators), and a
    within-block term of at most ``block`` bound comparisons an instance."""

    sorted_gauss: torch.Tensor  # (M,) int64: sorted position → depth rank
    tile_starts: torch.Tensor  # (T+1,) int32
    dest: torch.Tensor  # (M,) int64: slot → sorted position
    offsets: torch.Tensor  # (N,) int64: each depth rank's first slot
    depth_perm: torch.Tensor  # (N,) int64
    num_instances: int
    overflow: bool


_RANK_BLOCK = 16  # Gaussians per histogram block


def plan_instances(
    prep: Preprocessed, grid_x: int, grid_y: int, capacity: int, block: int = _RANK_BLOCK,
) -> InstancePlan:
    """The sort-free counterpart of :func:`bin_gaussians` (see
    :class:`InstancePlan`).  The histograms' products run in IEEE fp32: a
    count must be exact."""
    with tracing.span("binning"):
        prep = strip_row_footprints(prep)  # destinations decode rects
        if grid_x >= 1024 or grid_y >= 1024:
            raise ValueError(f"packed bounds hold 10 bits: grid {grid_x}x{grid_y}")
        num_tiles = grid_x * grid_y
        d = _depth_order(prep)
        n = d.tiles.shape[0]
        device = d.tiles.device
        slots, gauss_rank, tile = _rect_slots(d, grid_x, capacity)
        in_range = slots < d.total
        tx, ty = tile % grid_x, tile // grid_x

        # Block histograms of rect coverage: hist[b, ty, tx].
        contrib = d.tiles > 0
        nb = -(-n // block)
        pad = nb * block - n

        def indicator(axis, size):
            i = torch.arange(size, device=device)[None, :]
            ind = ((i >= d.rect_min[:, axis:axis + 1]) & (i < d.rect_max[:, axis:axis + 1])
                   & contrib[:, None]).to(torch.float32)
            return torch.nn.functional.pad(ind, (0, 0, 0, pad)).reshape(nb, block, size)

        with ieee_fp32_matmul():
            hist = torch.bmm(indicator(1, grid_y).transpose(1, 2), indicator(0, grid_x))
        hist = hist.reshape(nb, num_tiles).to(torch.int32)
        base = torch.cumsum(hist, dim=0, dtype=torch.int32)
        counts = (base[-1].clone() if nb
                  else torch.zeros(num_tiles, dtype=torch.int32, device=device))
        base -= hist  # exclusive over blocks
        del hist
        # On overflow the deepest instances are cut; no start points past the buffer.
        tile_starts = torch.clamp_max(
            torch.cat([torch.zeros(1, dtype=torch.int64, device=device),
                       torch.cumsum(counts, dim=0)]), capacity).to(torch.int32)

        # Within-block coverage of the instance's tile by earlier Gaussians.
        b_i, l_i = gauss_rank // block, gauss_rank % block
        never = 1023  # x0 = 1023, x1 = 0: covers nothing

        def packed(axis):
            v = torch.where(contrib, d.rect_min[:, axis] | (d.rect_max[:, axis] << 10),
                            torch.full_like(d.tiles, never))
            v = torch.nn.functional.pad(v, (0, pad), value=never)
            return v.to(torch.int32).reshape(nb, block)

        rowx, rowy = packed(0)[b_i], packed(1)[b_i]  # (M, B)
        lane = torch.arange(block, device=device)[None, :]
        cover = ((tx[:, None] >= (rowx & 1023)) & (tx[:, None] < (rowx >> 10))
                 & (ty[:, None] >= (rowy & 1023)) & (ty[:, None] < (rowy >> 10))
                 & (lane < l_i[:, None]))
        rank_wb = torch.sum(cover, dim=1)
        del rowx, rowy, cover

        base_g = base.reshape(-1)[torch.clamp(b_i * num_tiles + tile, 0, nb * num_tiles - 1)]
        dest = tile_starts.long()[torch.clamp(tile, 0, num_tiles)] + base_g + rank_wb
        dest = torch.where(in_range, dest, slots)  # padding slots stay in place
        keep = dest < capacity
        sorted_gauss = torch.zeros(capacity, dtype=torch.int64, device=device)
        sorted_gauss[dest[keep]] = gauss_rank[keep]
        plan = InstancePlan(
            sorted_gauss=sorted_gauss,
            tile_starts=tile_starts,
            dest=dest,
            offsets=d.offsets,
            depth_perm=d.depth_perm,
            num_instances=min(d.total, capacity),
            overflow=d.total > capacity,
        )
    tracing.count("raster.instances", plan.num_instances)
    tracing.count("raster.capacity", capacity)
    tracing.count("raster.overflows", plan.overflow)
    return plan


def sort_instances(
    slot_rank: torch.Tensor, slot_tile: torch.Tensor, n: int, num_tiles: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort slot-order instances by (tile, depth rank).

    Returns ``(gauss_s, tile_s, tile_starts)``: the depth rank per sorted
    instance (``n`` for padding), its tile (``num_tiles`` for padding), and
    the (T+1,) int32 range starts.
    """
    with tracing.span("binning"):
        sentinel = num_tiles << 32
        key = torch.where(
            slot_tile < num_tiles,
            (slot_tile.to(torch.int64) << 32) | slot_rank.to(torch.int64),
            torch.full_like(slot_tile, sentinel, dtype=torch.int64),
        )
        key_s = torch.sort(key).values
        boundaries = torch.arange(num_tiles + 1, dtype=torch.int64, device=key.device) << 32
        tile_starts = torch.searchsorted(key_s, boundaries, right=False).to(torch.int32)
        padding = key_s >= sentinel
        gauss_s = torch.where(padding, torch.full_like(key_s, n), key_s & 0xFFFFFFFF)
        tile_s = torch.where(padding, torch.full_like(key_s, num_tiles), key_s >> 32)
        return gauss_s, tile_s, tile_starts


def bin_gaussians(prep: Preprocessed, grid_x: int, grid_y: int, capacity: int) -> Binned:
    """Expand Gaussians into per-tile instances sorted by (tile, depth)."""
    n = prep.tiles_touched.shape[0]
    plan = expand_slots(prep, grid_x, grid_y, capacity)
    gauss_s, tile_s, tile_starts = sort_instances(plan.slot_rank, plan.slot_tile, n,
                                                  grid_x * grid_y)
    return Binned(gauss_id=gauss_s, tile_id=tile_s, tile_starts=tile_starts,
                  depth_perm=plan.depth_perm, num_instances=plan.num_instances,
                  overflow=plan.overflow)
