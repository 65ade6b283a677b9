"""Per-mask CLIP feature extraction.

Counterpart of ``seganygaussians_tpu/cli/get_clip_features.py``: reads
``images/`` and ``sam_masks/<image>.pt``, blanks the background of each mask,
crops to its bounding box, CLIP-encodes the crop and writes
``clip_features/<image>.pt`` stacks, the sidecars the text prompts score.

    python -m seganygaussians_torch.cli.get_clip_features --image_root <scene>

``--model_name`` names either an OpenCLIP architecture (``ViT-B-16``, with
the reference's laion2b weights) or an HF checkpoint (a hub id such as
``openai/clip-vit-base-patch16``, or a local directory); each goes to the
encoder argument of its kind.  Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser


def encoder_kwargs(model_name: str) -> dict:
    """The ``ClipEncoder`` argument that ``--model_name`` sets: an HF
    checkpoint (``org/name``, or a local directory) is ``hf_model_name``; any
    other name is an OpenCLIP ``model_name``."""
    if "/" in model_name or os.path.isdir(model_name):
        return {"hf_model_name": model_name}
    return {"model_name": model_name}


def main(argv=None):
    from seganygaussians_torch.cli.render import select_device
    from seganygaussians_torch.seg import clip_text
    from seganygaussians_torch.seg.clip_image import extract_scene_clip_features

    parser = ArgumentParser(description="Get CLIP features with SAM masks")
    parser.add_argument("--image_root", type=str, required=True)
    parser.add_argument("--background", type=float, default=0.0,
                        help="blanked-background gray level in [0,1] (reference uses 0)")
    parser.add_argument("--model_name", type=str, default="openai/clip-vit-base-patch16")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    device = select_device(args.device)
    encoder = clip_text.ClipEncoder(**encoder_kwargs(args.model_name), device=device)
    print(f"CLIP encoder backend: {encoder.backend}")
    written = extract_scene_clip_features(args.image_root, encoder, background=args.background)
    print(f"wrote {len(written)} clip_features sidecars")
    return 0


if __name__ == "__main__":
    sys.exit(main())
