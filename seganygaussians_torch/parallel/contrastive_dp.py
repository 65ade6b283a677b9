"""Camera × ray-block data-parallel contrastive step.

Counterpart of ``seganygaussians_tpu/parallel/contrastive_dp.py``, over a
("data", "ray") mesh:

* the "data" axis takes cameras: each data row trains its own view, and the
  feature and gate gradients are averaged over it, as in the scene step;
* the "ray" axis cuts the quadratic object, the (S, R, R) ray correlations,
  into block rows: every rank renders its camera's whole feature map and
  forms only its (S, R/ray, R) block of the correlations, the GT and the
  pair weights.  The pair counts and the loss numerators are summed over
  "ray".

The step is written once, as one camera's step on one ray block
(``train/contrastive_trainer.py``: ``contrastive_block_step``, a generator
of its collectives); the single-camera step is that step alone on its mesh.
This module runs it over a mesh.  Every random number is drawn at the full
ray count (a ``StepDraws`` per camera) and sliced to the rank's block, so
the ranks of a camera draw what the single-camera step draws, and a caller
can hand in another implementation's draws.
"""

from __future__ import annotations

from typing import Union

import torch
from torch.distributed.device_mesh import DeviceMesh

from seganygaussians_torch.ops.camera import CameraParams
from seganygaussians_torch.ops.rasterize import RasterConfig
from seganygaussians_torch.parallel.mesh import Layout, run_distributed, run_in_turn
from seganygaussians_torch.train.contrastive_trainer import (
    ContrastiveHyper,
    MaskBundle,
    StepDraws,
    contrastive_block_step,
)


def stack_bundles(bundles: list[MaskBundle]) -> MaskBundle:
    """Per-camera mask bundles stacked to (D, ...) for the data axis."""
    return MaskBundle(
        masks=torch.stack([b.masks for b in bundles]),
        scales=torch.stack([b.scales for b in bundles]),
        n_valid=torch.stack([b.n_valid for b in bundles]),
    )


def make_dp_contrastive_step(
    mesh: Union[DeviceMesh, Layout],
    template: CameraParams,
    hyper: ContrastiveHyper,
    config: RasterConfig,
):
    """The (cameras × ray blocks) contrastive step over ``mesh``'s "data"
    and "ray" axes.

    Returns ``run(feat_state, gate, gate_opt, cameras, bundles, consts,
    draws) -> (feat_state, gate, gate_opt, loss, overflow, feature grads or
    None)``: ``cameras`` a list of D ``CameraParams`` (the template's
    resolution), ``bundles`` stacked by :func:`stack_bundles`, ``draws`` a
    list of D ``StepDraws`` at the full ray count.  Over a ``DeviceMesh`` each
    process runs its coordinate; over a ``Layout`` every rank runs in turn
    here and rank 0's result is returned."""
    names = mesh.mesh_dim_names if isinstance(mesh, DeviceMesh) else mesh.names
    if tuple(names) != ("data", "ray"):
        raise ValueError(f"the contrastive step needs a ('data', 'ray') mesh, got {names}")
    layout = mesh if isinstance(mesh, Layout) else Layout.of(mesh)
    ray_size = layout.size("ray")

    def rank_step(args, coord):
        feat_state, gate, gate_opt, cameras, bundles, consts, draws = args
        i = coord["data"]
        if len(cameras) != layout.size("data") or len(draws) != len(cameras):
            raise ValueError(f"need {layout.size('data')} cameras and draws")
        camera = cameras[i]
        if (camera.width, camera.height) != (template.width, template.height):
            raise ValueError("a camera's resolution differs from the template's")
        bundle = MaskBundle(bundles.masks[i], bundles.scales[i], bundles.n_valid[i])
        return contrastive_block_step(feat_state, gate, gate_opt, camera, bundle, consts,
                                      draws[i], hyper, config, coord["ray"], ray_size)

    def run(feat_state, gate, gate_opt, cameras, bundles, consts,
            draws: list[StepDraws]) -> tuple:
        args = (feat_state, gate, gate_opt, cameras, bundles, consts, draws)
        if isinstance(mesh, Layout):
            steps = {r: rank_step(args, c) for r, c in enumerate(mesh.coords())}
            result = run_in_turn(steps, mesh)[0]
        else:
            coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
            result = run_distributed(rank_step(args, coord), mesh)
        feat_state, gate, gate_opt, aux = result
        return feat_state, gate, gate_opt, aux["loss"], aux["overflow"], aux.get("feat_grads")

    return run

