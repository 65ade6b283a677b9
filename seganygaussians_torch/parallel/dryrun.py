"""A dry run of the three parallel steps on a tiny scene.

Counterpart of ``__graft_entry__.py:dryrun_multichip``: one scene
data-parallel train step (then four timed), one contrastive step over a
("data", "ray") mesh of (2, world/2) when the world size is even, and one
tile-sharded loss and gradient, each printing one line.  Run one process per
rank:

    torchrun --nproc_per_node 2 -m seganygaussians_torch.parallel.dryrun --device cpu

(gloo on the CPU; without ``--device cpu``, NCCL with one card a rank).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from seganygaussians_torch.data.cameras import orbit_camera_params
from seganygaussians_torch.models import feature_gaussians as fgm
from seganygaussians_torch.models import gaussians as gm
from seganygaussians_torch.models import optim
from seganygaussians_torch.ops.camera import make_camera
from seganygaussians_torch.ops.quantile import fit_quantile_transform
from seganygaussians_torch.ops.rasterize import RasterConfig
from seganygaussians_torch.parallel import contrastive_dp, data_parallel, tile_sharded
from seganygaussians_torch.parallel.mesh import initialize_distributed, make_mesh
from seganygaussians_torch.seg.scale_gate import init_scale_gate
from seganygaussians_torch.train import contrastive_trainer as ct


def tiny_scene(device, n=128, capacity=256, seed=0):
    """``__graft_entry__.py:_tiny_scene``'s points at SH degree 0."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.6, 0.6, n),
                    3.0 + rng.uniform(-0.5, 0.5, n)], axis=1).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    return gm.create_from_points(pts, cols, 0, capacity, device=device)


def dryrun(device: torch.device) -> list[str]:
    """The three steps on this process's rank; returns the lines printed."""
    world = dist.get_world_size()
    lines = []

    def say(line):
        if dist.get_rank() == 0:
            print(line, flush=True)
        lines.append(line)

    state = tiny_scene(device)
    bg = torch.zeros(3, device=device)
    cams = [orbit_camera_params(np.zeros(3), 2.5, 2 * np.pi * i / world, 0.12, 0.7, 64, 48)
            for i in range(world)]
    cam_batch, template = data_parallel.stack_cameras(cams)
    rng = np.random.default_rng(1)
    gt_batch = torch.tensor(rng.uniform(size=(world, 48, 64, 3)), dtype=torch.float32,
                            device=device)
    cfg = RasterConfig(capacity=1 << 12)
    step = data_parallel.make_dp_train_step(make_mesh(world), template, gm.TrainHyper(), cfg,
                                            spatial_lr_scale=2.5)
    state, loss, _ = step(state, cam_batch, gt_batch, bg, 1)
    if not torch.isfinite(loss):
        raise RuntimeError("dp step produced a non-finite loss")
    t0 = time.perf_counter()
    iters = 4
    for it in range(2, 2 + iters):
        state, loss, _ = step(state, cam_batch, gt_batch, bg, it)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = (time.perf_counter() - t0) / iters
    say(f"dryrun({world}) scene-dp ok: loss={float(loss):.4f} step={dt * 1e3:.1f}ms "
        f"total={world * 64 * 48 / dt / 1e6:.3f}Mpix/s")

    p = state.params
    if world % 2 == 0:
        fs = fgm.from_scene_geometry(p.xyz[:64], p.scaling[:64], p.rotation[:64],
                                     p.opacity[:64], feature_dim=8, smooth_k=4, device=device)
        h, w = 24, 32
        left = np.zeros((h, w), bool)
        left[:, : w // 2] = True
        scales = np.array([5.0, 1.0, 0.9], np.float32)
        bundle = ct.build_mask_bundle(np.stack([np.ones((h, w), bool), left, ~left]), scales,
                                      max_masks=4, device=device)
        consts = ct.ContrastiveConsts(
            upper_bound_scale=torch.tensor(5.0, device=device),
            qt=fit_quantile_transform(torch.tensor(scales, device=device)),
        )
        gate = init_scale_gate(torch.Generator(device=device).manual_seed(0), 8, device=device)
        cam = make_camera(np.eye(3), np.zeros(3), fovx=1.1, fovy=0.9, width=w, height=h)
        rays = world // 2
        hyper = ct.ContrastiveHyper(num_sampled_rays=16 * rays, smooth_dropout=0.5)
        bundles = contrastive_dp.stack_bundles([bundle, bundle])
        draws = [ct.draw_step(torch.Generator(device=device).manual_seed(i), bundle, hyper, 4)
                 for i in range(2)]
        cstep = contrastive_dp.make_dp_contrastive_step(
            make_mesh(world, ("data", "ray"), (2, rays)), cam, hyper, cfg)
        fs, _, _, closs, _, _ = cstep(fs, gate, optim.adam_init(gate), [cam, cam], bundles,
                                      consts, draws)
        if not torch.isfinite(closs):
            raise RuntimeError("dp contrastive step produced a non-finite loss")
        say(f"dryrun({world}) contrastive-dp ok: loss={float(closs):.4f}")

    tcam = make_camera(np.eye(3), np.zeros(3), fovx=1.1, fovy=0.9, width=64, height=64)
    rngt = np.random.default_rng(3)
    q = rngt.normal(size=(64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    lg = tile_sharded.make_tile_sharded_loss_grad(make_mesh(world, ("tiles",)), "tiles", tcam,
                                                  RasterConfig(capacity=1 << 11))
    (tloss, _), _ = lg(
        p.xyz[:64], torch.sigmoid(p.opacity[:64, 0]),
        torch.tensor(rngt.uniform(size=(64, 3)), dtype=torch.float32, device=device),
        torch.exp(p.scaling[:64]), torch.tensor(q, device=device), torch.zeros(3, device=device),
        torch.tensor(rngt.uniform(size=(64, 64, 3)), dtype=torch.float32, device=device),
    )
    if not torch.isfinite(tloss):
        raise RuntimeError("tile-sharded step produced a non-finite loss")
    say(f"dryrun({world}) tile-sharded ok: loss={float(tloss):.4f}")
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = parser.parse_args(argv)
    initialize_distributed(args.device)
    try:
        device = (torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda"
                  else torch.device("cpu"))
        dryrun(device)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
