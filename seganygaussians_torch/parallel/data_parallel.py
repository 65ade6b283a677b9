"""Camera-data-parallel scene training step.

Counterpart of ``seganygaussians_tpu/parallel/data_parallel.py``.  The
Gaussian parameters are replicated; each rank renders its own camera of a
D-camera batch and computes full parameter gradients; the gradients and the
loss are averaged over the "data" axis and the overflow flag maxed; Adam then
runs on every rank with the same result.  The densification statistics are
combined as over D sequential iterations: the gradient norms and visibility
counts summed, the screen radii maxed.

:func:`dp_train_rank` is one rank's step, a generator of its collectives
(``parallel/mesh.py``); :func:`make_dp_train_step` runs it over a
``DeviceMesh`` (one rank per process) or, over a :class:`~mesh.Layout`,
every rank in turn in this process.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from seganygaussians_torch.models import gaussians as gm
from seganygaussians_torch.models import optim
from seganygaussians_torch.ops.camera import CameraParams
from seganygaussians_torch.ops.rasterize import RasterConfig
from seganygaussians_torch.parallel.mesh import Layout, collective, run_distributed, run_in_turn
from seganygaussians_torch.train.scene_trainer import view_loss_and_grads


class CameraBatch(NamedTuple):
    """D cameras of one resolution (the leading axis is the data axis)."""

    world_view: np.ndarray  # (D, 4, 4)
    full_proj: np.ndarray  # (D, 4, 4)
    cam_center: np.ndarray  # (D, 3)


def stack_cameras(cams: list[CameraParams]) -> tuple[CameraBatch, CameraParams]:
    """Stack same-resolution cameras; returns (batch, the first camera as the
    template of the static fields)."""
    tpl = cams[0]
    for c in cams:
        if (c.width, c.height) != (tpl.width, tpl.height):
            raise ValueError("stack_cameras: mixed resolutions")
    return (
        CameraBatch(
            world_view=np.stack([np.asarray(c.world_view) for c in cams]),
            full_proj=np.stack([np.asarray(c.full_proj) for c in cams]),
            cam_center=np.stack([np.asarray(c.cam_center) for c in cams]),
        ),
        tpl,
    )


def camera_at(batch: CameraBatch, template: CameraParams, i: int) -> CameraParams:
    """Camera ``i`` of a batch, with the template's static fields."""
    return CameraParams(
        world_view=batch.world_view[i], full_proj=batch.full_proj[i],
        cam_center=batch.cam_center[i], width=template.width, height=template.height,
        tan_fovx=template.tan_fovx, tan_fovy=template.tan_fovy,
    )


def dp_train_rank(
    state: gm.GaussianState,
    camera: CameraParams,
    gt: torch.Tensor,  # (H, W, 3)
    bg: torch.Tensor,  # (3,)
    step: int,
    spatial_lr_scale: float,
    active_sh_degree: int,
    hyper: gm.TrainHyper,
    config: RasterConfig,
):
    """One rank's data-parallel train step, a generator of its collectives;
    returns (state, loss, overflow, the averaged parameter gradients)."""
    loss, _, param_grads, ndc_grad, radii, overflow = view_loss_and_grads(
        state, camera, gt, bg, active_sh_degree, hyper, config)

    with torch.no_grad():
        visible = radii > 0
        gnorm = torch.where(visible, torch.linalg.norm(ndc_grad, dim=-1), 0.0)
    loss, *param_grads = yield collective("mean", "data", loss, *param_grads)
    gnorm, n_visible = yield collective("sum", "data", gnorm, visible.to(torch.float32))
    overflow, max_radii = yield collective(
        "max", "data", torch.tensor(int(overflow), device=gnorm.device), radii.to(torch.float32))

    param_grads = gm.GaussianParams(*param_grads)
    with torch.no_grad():
        lrs = gm.make_lr_tree(hyper, spatial_lr_scale, step)
        new_params, new_opt = optim.adam_update(param_grads, state.opt, state.params, lrs)
        state = state._replace(
            params=new_params, opt=new_opt,
            xyz_grad_accum=state.xyz_grad_accum + gnorm,
            denom=state.denom + n_visible,
            max_radii2d=torch.maximum(state.max_radii2d, max_radii),
        )
    return state, loss, bool(overflow), param_grads


def make_dp_train_step(
    mesh: Union[DeviceMesh, Layout],
    template: CameraParams,
    hyper: gm.TrainHyper,
    config: RasterConfig,
    spatial_lr_scale: float,
    active_sh_degree: int = 0,
    debug_grads: bool = False,
):
    """The D-camera data-parallel train step over ``mesh``'s "data" axis.

    Returns ``run(state, cam_batch, gt_batch, bg, step) -> (state, loss,
    overflow)``, with ``gt_batch`` (D, H, W, 3), and the averaged parameter
    gradients after them if ``debug_grads`` (checks: Adam's first step is
    about sign(g), so the updated parameters say little of the gradient's
    size).  Over a ``DeviceMesh`` each process renders the camera at its
    coordinate; over a ``Layout`` every rank runs in turn here and rank 0's
    result (every rank's is the same) is returned."""

    def rank_step(state, cam_batch, gt_batch, bg, step, coord):
        i = coord["data"]
        return dp_train_rank(state, camera_at(cam_batch, template, i), gt_batch[i], bg, step,
                             spatial_lr_scale, active_sh_degree, hyper, config)

    def run(state, cam_batch, gt_batch, bg, step):
        if isinstance(mesh, Layout):
            steps = {r: rank_step(state, cam_batch, gt_batch, bg, step, c)
                     for r, c in enumerate(mesh.coords())}
            result = run_in_turn(steps, mesh)[0]
        else:
            coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
            result = run_distributed(rank_step(state, cam_batch, gt_batch, bg, step, coord),
                                     mesh)
        return result if debug_grads else result[:3]

    return run
