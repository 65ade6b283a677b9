"""Batch rendering CLI.

Counterpart of ``seganygaussians_tpu/cli/render.py``: renders the train/test
views of a saved model for a target ∈ {scene, seg, feature,
contrastive_feature}.  ``scene`` and ``seg`` write PNGs (``seg`` also
binarised 2D masks, and a precomputed 3D mask (.pt/.npy) can segment the
Gaussians first); the feature targets write one (H, W, D) ``.npy`` map per
view.

    python -m seganygaussians_torch.cli.render -s <scene> -m <model dir>

Runs on CUDA unless ``--device cpu`` is given; asking for CUDA on a machine
without it raises.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch


def select_device(name: str) -> torch.device:
    """The CLIs' device policy: CUDA must be there when asked for, and on it
    every fp32 matrix product and convolution runs without TF32."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda asked for, but no CUDA device is available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def main(argv=None):
    from PIL import Image

    from seganygaussians_torch import render as R
    from seganygaussians_torch.config import extract, load_cfg, make_parser
    from seganygaussians_torch.models import feature_gaussians as fgm
    from seganygaussians_torch.models import gaussians as gm
    from seganygaussians_torch.ops.rasterize import RasterConfig
    from seganygaussians_torch.scene import ModelConfig, Scene

    parser = make_parser("Batch rendering")
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--target", type=str, default="scene",
                        choices=("scene", "seg", "feature", "contrastive_feature"))
    # Accepted and never read, as by the JAX CLI's parser.
    parser.add_argument("--segment", action="store_true")
    parser.add_argument("--precomputed_mask", type=str, default=None)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--backend", type=str, default="auto")
    parser.add_argument("--raster_capacity", type=int, default=1 << 20)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    device = select_device(args.device)

    cfg = extract(ModelConfig, args)
    saved = load_cfg(cfg.model_path, "cfg_args")
    if saved and not cfg.source_path and "model" in saved:
        cfg.source_path = saved["model"].get("source_path", "")

    feature_mode = "feature" in args.target
    scene = Scene(
        cfg,
        need_scene=not feature_mode,
        need_features_model=feature_mode,
        load_iteration=args.iteration,
        feature_load_iteration=args.iteration if feature_mode else None,
        target=args.target,
        mode="eval",
        shuffle=False,
        device=device,
    )
    raster_cfg = RasterConfig(capacity=args.raster_capacity, backend=args.backend)
    bg = torch.tensor(
        [1.0, 1.0, 1.0] if cfg.white_background else [0.0, 0.0, 0.0],
        dtype=torch.float32, device=device,
    )

    if args.precomputed_mask and scene.gaussians is not None:
        if args.precomputed_mask.endswith(".pt"):
            mask3d = np.asarray(
                torch.load(args.precomputed_mask, map_location="cpu", weights_only=False)
            ).astype(bool)
        else:
            mask3d = np.load(args.precomputed_mask).astype(bool)
        cap = scene.gaussians.alive.shape[0]
        m = np.zeros(cap, bool)
        m[: len(mask3d)] = mask3d
        scene.gaussians = gm.segment(scene.gaussians, torch.from_numpy(m).to(device))

    it = scene.loaded_iter or scene.feature_loaded_iter or args.iteration
    splits = []
    if not args.skip_train:
        splits.append(("train", scene.get_train_cameras()))
    if not args.skip_test and scene.get_test_cameras():
        splits.append(("test", scene.get_test_cameras()))

    with torch.no_grad():
        for split, cams in splits:
            out_dir = os.path.join(cfg.model_path, args.target, f"ours_{it}", split, "renders")
            os.makedirs(out_dir, exist_ok=True)
            for idx, cam in enumerate(cams):
                if feature_mode:
                    fs = scene.feature_gaussians
                    pkg = R.render_features(
                        cam.params, fs.geom.xyz, fgm.get_opacity(fs.geom)[:, 0],
                        fgm.get_scaling(fs.geom), fgm.get_rotation(fs.geom),
                        fs.point_features, config=raster_cfg,
                    )
                else:
                    pkg = R.render(cam.params, scene.gaussians, bg, config=raster_cfg)
                if pkg["overflow"]:
                    raise RuntimeError(
                        f"instance capacity {args.raster_capacity} exceeded on view "
                        f"{cam.image_name}; raise --raster_capacity"
                    )
                if feature_mode:
                    np.save(os.path.join(out_dir, f"{idx:05d}.npy"), pkg["render"].cpu().numpy())
                    continue
                img = np.clip(pkg["render"].cpu().numpy(), 0, 1)
                Image.fromarray((img * 255).astype(np.uint8)).save(
                    os.path.join(out_dir, f"{idx:05d}.png")
                )
                if args.target == "seg":
                    mpkg = R.render_mask(cam.params, scene.gaussians, bg, config=raster_cfg)
                    m2d = (mpkg["mask"].cpu().numpy() > 0.5).astype(np.uint8) * 255
                    mask_dir = out_dir.replace("renders", "masks")
                    os.makedirs(mask_dir, exist_ok=True)
                    Image.fromarray(m2d).save(os.path.join(mask_dir, f"{idx:05d}.png"))
            print(f"rendered {len(cams)} {split} views → {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
