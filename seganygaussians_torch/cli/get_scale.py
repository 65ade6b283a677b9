"""Per-mask 3D scale extraction CLI.

Counterpart of ``seganygaussians_tpu/cli/get_scale.py``: reads
``sam_masks/<image>.pt``, renders depth through the trained scene model and
writes ``mask_scales/<image>.pt`` (torch tensors, reference-compatible) INTO
THE SOURCE DIRECTORY, beside the masks, as the reference does.

    python -m seganygaussians_torch.cli.get_scale -s <scene> -m <model dir>

Runs on CUDA unless ``--device cpu`` is given; asking for CUDA on a machine
without it raises.
"""

from __future__ import annotations

import os
import sys

import torch


def main(argv=None):
    from seganygaussians_torch.cli.render import select_device
    from seganygaussians_torch.config import extract, load_cfg, make_parser
    from seganygaussians_torch.ops.rasterize import RasterConfig
    from seganygaussians_torch.preprocess import compute_mask_scales
    from seganygaussians_torch.scene import ModelConfig, Scene

    parser = make_parser("Mask scale extraction")
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--backend", type=str, default="auto")
    parser.add_argument("--raster_capacity", type=int, default=1 << 20)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    device = select_device(args.device)

    cfg = extract(ModelConfig, args)
    saved = load_cfg(cfg.model_path, "cfg_args")
    if saved and not cfg.source_path and "model" in saved:
        cfg.source_path = saved["model"].get("source_path", "")
    cfg.need_masks = True

    scene = Scene(cfg, load_iteration=args.iteration, mode="train", target="scene",
                  shuffle=False, device=device)
    raster_cfg = RasterConfig(capacity=args.raster_capacity, backend=args.backend)

    out_dir = os.path.join(cfg.source_path, "mask_scales")
    os.makedirs(out_dir, exist_ok=True)
    for cam in scene.get_train_cameras():
        masks = cam.sam_masks
        if masks is None:
            print(f"skip {cam.image_name}: no sam_masks sidecar")
            continue
        scales = compute_mask_scales(cam, scene.gaussians, masks, raster_cfg).cpu()
        torch.save(scales, os.path.join(out_dir, cam.image_name + ".pt"))
        print(f"{cam.image_name}: {len(scales)} masks, "
              f"scale range [{float(scales.min()):.3f}, {float(scales.max()):.3f}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
