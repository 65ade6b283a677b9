"""Tile-row sharding of the raster grid.

Counterpart of ``seganygaussians_tpu/parallel/tile_sharded.py``.  Each rank
blends one slab of tile rows against the whole (replicated) Gaussian set:
preprocess runs on every rank (it is N-sized), each Gaussian's tile rect is
clipped to the slab, and the slot expansion and the blend run on the slab
alone, so each rank's instances and blend grid shrink to about 1/D.  The
render gathers the slabs' images by rows; the loss and the parameter
gradients are sums over the slabs, each rank differentiating its own slab,
which gives the single-rank rasterizer's gradients.  On CUDA tensors each
slab runs the two Hopper blend kernels; on CPU tensors the plain version.

:func:`slab_render_rank` and :func:`slab_loss_grad_rank` are one rank's
work, generators of their collectives (``parallel/mesh.py``); the
``make_*`` functions run them over a ``DeviceMesh`` or, over a
:class:`~mesh.Layout`, every slab in turn in this process.
"""

from __future__ import annotations

from typing import Union

import torch
from torch.distributed.device_mesh import DeviceMesh

from seganygaussians_torch.ops import blend as blend_torch
from seganygaussians_torch.ops import blend_cuda
from seganygaussians_torch.ops.binning import expand_slots
from seganygaussians_torch.ops.camera import CameraParams
from seganygaussians_torch.ops.projection import Preprocessed, preprocess
from seganygaussians_torch.ops.rasterize import RasterConfig
from seganygaussians_torch.parallel.mesh import Layout, collective, run_distributed, run_in_turn


def clip_to_tile_rows(prep: Preprocessed, row_lo: int, row_hi: int) -> Preprocessed:
    """Every Gaussian's tile rect intersected with tile rows [row_lo, row_hi),
    in slab coordinates (row_lo maps to 0), with ``tiles_touched`` recounted;
    a Gaussian off the slab touches no tile.  Row intervals are dropped:
    they are indexed by absolute row, and the count is the rect's."""
    y0 = torch.clamp_min(prep.rect_min[:, 1], row_lo) - row_lo
    y1 = torch.clamp_max(prep.rect_max[:, 1], row_hi) - row_lo
    h = torch.clamp_min(y1 - y0, 0)
    w = torch.clamp_min(prep.rect_max[:, 0] - prep.rect_min[:, 0], 0)
    return prep._replace(
        rect_min=torch.stack([prep.rect_min[:, 0], torch.clamp_min(y0, 0)], dim=-1),
        rect_max=torch.stack([prep.rect_max[:, 0], torch.clamp_min(y1, 0)], dim=-1),
        tiles_touched=torch.where(prep.valid, w * h, torch.zeros_like(w)).to(torch.int32),
        valid=prep.valid & (h > 0),
        row_pack=None,
    )


def _slabs(camera: CameraParams, tile_size: int, n_slabs: int) -> tuple[int, int, int]:
    """(grid_x, tile rows a slab, padded tile rows): the grid's rows padded
    up to a multiple of the slab count."""
    grid_x = (camera.width + tile_size - 1) // tile_size
    grid_y = (camera.height + tile_size - 1) // tile_size
    rows_pad = -(-grid_y // n_slabs) * n_slabs
    return grid_x, rows_pad // n_slabs, rows_pad


def _slab_blend(means3d, opacities, colors, scales, rotations, bg, camera, config, row_lo,
                rows_local):
    """One slab: preprocess, clip, expand, blend.  Returns (BlendOutput,
    overflow, grid_x)."""
    ts = config.tile_size
    grid_x = (camera.width + ts - 1) // ts
    prep = preprocess(means3d, camera, scales=scales, rotations=rotations, tile_size=ts,
                      opacities=opacities)
    plan = expand_slots(clip_to_tile_rows(prep, row_lo, row_lo + rows_local), grid_x,
                        rows_local, config.capacity)
    perm = plan.depth_perm
    m2, co = prep.means2d[perm], prep.conics[perm]
    # Slab pixel coordinates: the slab's grid starts at pixel row row_lo·ts
    # (conics do not depend on the origin).
    fields = (m2[:, 0], m2[:, 1] - float(row_lo * ts), co[:, 0], co[:, 1], co[:, 2],
              opacities[perm]) + tuple(colors[perm].unbind(-1))
    out = blend_cuda.blend_fused(plan.slot_rank, plan.slot_tile, fields, bg, grid_x,
                                 rows_local, ts)
    return out, plan.overflow, grid_x


def slab_render_rank(means3d, opacities, colors, scales, rotations, bg, camera: CameraParams,
                     config: RasterConfig, axis: str, slab: int, n_slabs: int):
    """One rank's slab of the render; returns ((H, W, C) image, overflow)."""
    ts = config.tile_size
    _, rows_local, _ = _slabs(camera, ts, n_slabs)
    with torch.no_grad():
        out, overflow, grid_x = _slab_blend(means3d, opacities, colors, scales, rotations, bg,
                                            camera, config, slab * rows_local, rows_local)
        img = blend_torch.tiles_to_image(out.tiles, grid_x, rows_local, ts, grid_x * ts,
                                         rows_local * ts)
    img, overflow = yield collective("gather", axis, img,
                                     torch.tensor([int(overflow)], device=img.device))
    return img[: camera.height, : camera.width], bool(overflow.any())


def slab_loss_grad_rank(means3d, opacities, colors, scales, rotations, bg, gt,
                        camera: CameraParams, config: RasterConfig, axis: str, slab: int,
                        n_slabs: int):
    """One rank's slab of the L1 loss over the whole image and its gradients
    with respect to (means3d, opacities, colors, scales, rotations); returns
    ((loss, overflow), grads) once summed over the slabs."""
    ts = config.tile_size
    _, rows_local, rows_pad = _slabs(camera, ts, n_slabs)
    row_lo = slab * rows_local
    denom = float(camera.height * camera.width * gt.shape[-1])
    # The slab's rows of gt, zero past the image (a zero mask below as well).
    gt_pad = torch.zeros((rows_pad * ts, camera.width, gt.shape[-1]), dtype=gt.dtype,
                         device=gt.device)
    gt_pad[: camera.height] = gt
    gt_slab = gt_pad[row_lo * ts:(row_lo + rows_local) * ts]
    leaves = [x.detach().requires_grad_(True)
              for x in (means3d, opacities, colors, scales, rotations)]
    out, overflow, grid_x = _slab_blend(*leaves, bg, camera, config, row_lo, rows_local)
    img = blend_torch.tiles_to_image(out.tiles, grid_x, rows_local, ts, camera.width,
                                     rows_local * ts)
    inside = (torch.arange(rows_local * ts, device=img.device) + row_lo * ts
              < camera.height)[:, None, None]
    loss = torch.sum(torch.abs(img - gt_slab) * inside) / denom
    grads = torch.autograd.grad(loss, leaves)
    del out, img
    loss, *grads = yield collective("sum", axis, loss.detach(), *grads)
    (overflow,) = yield collective("max", axis, torch.tensor(int(overflow), device=loss.device))
    return (loss, bool(overflow)), tuple(grads)


def _runner(mesh: Union[DeviceMesh, Layout], axis: str, rank_fn, *static):
    layout = mesh if isinstance(mesh, Layout) else Layout.of(mesh)
    if layout.names != (axis,):
        raise ValueError(f"tile sharding runs on a 1-D mesh named ({axis!r},), got {layout}")
    n_slabs = layout.size(axis)

    def run(*args):
        if isinstance(mesh, Layout):
            steps = {r: rank_fn(*args, *static, axis, r, n_slabs) for r in range(n_slabs)}
            return run_in_turn(steps, mesh)[0]
        slab = mesh.get_coordinate()[0]
        return run_distributed(rank_fn(*args, *static, axis, slab, n_slabs), mesh)

    return run


def make_tile_sharded_render(mesh: Union[DeviceMesh, Layout], axis: str,
                             camera: CameraParams, config: RasterConfig = RasterConfig()):
    """``render(means3d, opacities, colors, scales, rotations, bg) -> ((H, W, C)
    image, overflow)``, each rank blending ``rows_pad / D`` tile rows (the
    grid's rows padded to a multiple of the axis size ``D``)."""
    return _runner(mesh, axis, slab_render_rank, camera, config)


def make_tile_sharded_loss_grad(mesh: Union[DeviceMesh, Layout], axis: str,
                                camera: CameraParams, config: RasterConfig = RasterConfig()):
    """``step(means3d, opacities, colors, scales, rotations, bg, gt) ->
    ((loss, overflow), grads)``: the mean absolute error against ``gt`` (H, W, C)
    summed over the slabs, and its gradients with respect to the first five
    arguments, each rank differentiating its own slab."""
    return _runner(mesh, axis, slab_loss_grad_rank, camera, config)
