"""SAM segment-everything mask extraction.

Counterpart of ``seganygaussians_tpu/cli/extract_segment_everything_masks.py``:
runs ``SamAutomaticMaskGenerator`` (ViT-H, 32×32 point grid, pred_iou 0.88,
stability 0.95) on every image and saves a bool mask stack to
``sam_masks/<image>.pt``.  SAM is a frozen offline preprocessing model: it
needs the ``segment_anything`` package and a checkpoint on disk, both
optional.  Without the package the command exits with status 2.

    python -m seganygaussians_torch.cli.extract_segment_everything_masks \\
        --image_root <scene> --sam_checkpoint_path <sam_vit_h.pth>

Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import os
import sys


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--image_root", type=str, required=True)
    parser.add_argument("--sam_checkpoint_path", type=str, required=True)
    parser.add_argument("--sam_arch", type=str, default="vit_h")
    parser.add_argument("--downsample", type=str, default="1", choices=["1", "2", "4", "8"])
    parser.add_argument("--downsample_type", type=str, default="image",
                        choices=["image", "mask"])
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    try:
        from segment_anything import SamAutomaticMaskGenerator, sam_model_registry
    except ImportError as e:
        print(
            "segment_anything is not installed — SAM extraction is an offline "
            "preprocessing step; install it (and download a ViT-H checkpoint) "
            "or bring precomputed sam_masks/*.pt sidecars.",
            file=sys.stderr,
        )
        raise SystemExit(2) from e

    import numpy as np
    import torch
    from PIL import Image

    from seganygaussians_torch.cli.render import select_device

    device = select_device(args.device)
    downsample = int(args.downsample)
    sam = sam_model_registry[args.sam_arch](checkpoint=args.sam_checkpoint_path).to(device)
    generator = SamAutomaticMaskGenerator(
        model=sam,
        points_per_side=32,
        pred_iou_thresh=0.88,
        box_nms_thresh=0.7,
        stability_score_thresh=0.95,
        crop_n_layers=0,
        crop_n_points_downscale_factor=1,
        min_mask_region_area=100,
    )

    images_dir = os.path.join(args.image_root, "images")
    out_dir = os.path.join(args.image_root, "sam_masks")
    os.makedirs(out_dir, exist_ok=True)
    for name in sorted(os.listdir(images_dir)):
        img = np.array(Image.open(os.path.join(images_dir, name)).convert("RGB"))
        if args.downsample_type == "image" and downsample > 1:
            h, w = img.shape[:2]
            img = np.array(Image.fromarray(img).resize((w // downsample, h // downsample)))
        masks = generator.generate(img)
        stack = torch.from_numpy(np.stack([m["segmentation"] for m in masks])).bool()
        if args.downsample_type == "mask" and downsample > 1:
            stack = torch.nn.functional.interpolate(
                stack[None].float(),
                (stack.shape[-2] // downsample, stack.shape[-1] // downsample),
                mode="nearest",
            )[0].bool()
        torch.save(stack, os.path.join(out_dir, name.split(".")[0] + ".pt"))
        print(f"{name}: {len(stack)} masks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
