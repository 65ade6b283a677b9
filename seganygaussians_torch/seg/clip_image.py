"""Per-SAM-mask CLIP image features.

Counterpart of ``seganygaussians_tpu/seg/clip_image.py``, copied: per image,
upsample the mask stack to the image's resolution, binarize at 0.5, blank
the background (mask · image + (1 − mask) · 255 · bg), crop each masked image
to the mask's bounding box and encode the crop; the (K, C) feature stack is
saved as ``clip_features/<image>.pt``.

The preprocessing is host numpy and PIL: it is offline, per scene, and
bounded by the encoder.  The encoder is injected (any object with
``encode_image(list[np.ndarray]) -> (B, C)``), so the pipeline runs without
CLIP weights.
"""

from __future__ import annotations

import os

import numpy as np


def binarize_masks_to_image(masks: np.ndarray, image_shape) -> np.ndarray:
    """Bilinear-resize a (K, h, w) mask stack to ``image_shape`` = (H, W) and
    binarize at 0.5 (`clip_utils/__init__.py:99-104`)."""
    masks = np.asarray(masks, np.float32)
    k, h, w = masks.shape
    ih, iw = image_shape
    if (h, w) != (ih, iw):
        from PIL import Image

        resized = np.empty((k, ih, iw), np.float32)
        for i in range(k):
            resized[i] = np.asarray(
                Image.fromarray(masks[i]).resize((iw, ih), Image.BILINEAR)
            )
        masks = resized
    return masks > 0.5


def mask_bbox(mask: np.ndarray):
    """Tight bounding box (y0, y1, x0, x1), end-exclusive, or None if the
    mask is empty (torchvision ``masks_to_boxes`` analogue)."""
    ys, xs = np.nonzero(mask)
    if ys.size == 0:
        return None
    return int(ys.min()), int(ys.max()) + 1, int(xs.min()), int(xs.max()) + 1


def masked_crops(
    image: np.ndarray,  # (H, W, 3) uint8 or float in [0, 255]
    masks: np.ndarray,  # (K, h, w) bool/float at any resolution
    background: float = 0.0,
) -> tuple[list, list]:
    """Background-blanked bbox crops for every mask.

    Returns (crops, empty_indices): ``crops`` holds one (hᵢ, wᵢ, 3) float32
    array per non-empty mask; ``empty_indices`` lists masks with no pixels
    (their features are zeroed by the caller).  ``background`` follows the
    reference call (`get_clip_features.py:31`: background=0 → black)."""
    image = np.asarray(image, np.float32)
    bin_masks = binarize_masks_to_image(masks, image.shape[:2])
    crops, empty = [], []
    for i, m in enumerate(bin_masks):
        box = mask_bbox(m)
        if box is None:
            empty.append(i)
            continue
        y0, y1, x0, x1 = box
        blanked = np.where(
            m[:, :, None], image, 255.0 * background
        )  # (H, W, 3)
        crops.append(blanked[y0:y1, x0:x1])
    return crops, empty


def mask_clip_features(
    image: np.ndarray,
    masks: np.ndarray,
    encoder,
    background: float = 0.0,
    batch_size: int = 32,
) -> np.ndarray:
    """(K, C) normalized CLIP features, one per mask (zeros for empty
    masks) — the `get_features_from_image_and_masks` equivalent."""
    crops, empty = masked_crops(image, masks, background)
    feats = []
    for i in range(0, len(crops), batch_size):
        feats.append(np.asarray(encoder.encode_image(crops[i : i + batch_size])))
    enc = (
        np.concatenate(feats, axis=0)
        if feats
        else np.zeros((0, getattr(encoder, "dim", 512)), np.float32)
    )
    k = masks.shape[0]
    c = enc.shape[-1] if enc.size else getattr(encoder, "dim", 512)
    out = np.zeros((k, c), np.float32)
    keep = [i for i in range(k) if i not in set(empty)]
    for slot, row in zip(keep, enc):
        out[slot] = row
    return out


def extract_scene_clip_features(
    image_root: str,
    encoder,
    background: float = 0.0,
    image_dir: str = "images",
    mask_dir: str = "sam_masks",
    out_dir: str = "clip_features",
    log=print,
) -> list[str]:
    """Reference-compatible scene sweep (`get_clip_features.py:23-35`): for
    every image with a ``sam_masks`` sidecar, write
    ``clip_features/<image>.pt`` holding the (K, C) torch tensor."""
    import torch
    from PIL import Image

    img_root = os.path.join(image_root, image_dir)
    msk_root = os.path.join(image_root, mask_dir)
    out_root = os.path.join(image_root, out_dir)
    os.makedirs(out_root, exist_ok=True)
    written = []
    for name in sorted(os.listdir(img_root)):
        stem = os.path.splitext(name)[0]
        mask_path = None
        for cand in (stem + ".pt", name + ".pt"):
            if os.path.exists(os.path.join(msk_root, cand)):
                mask_path = os.path.join(msk_root, cand)
                break
        if mask_path is None:
            log(f"skip {name}: no sam_masks sidecar")
            continue
        image = np.asarray(Image.open(os.path.join(img_root, name)).convert("RGB"))
        masks = torch.load(mask_path, map_location="cpu", weights_only=False)
        masks = np.asarray(masks, np.float32)
        feats = mask_clip_features(image, masks, encoder, background)
        out_path = os.path.join(out_root, os.path.basename(mask_path))
        torch.save(torch.tensor(feats), out_path)
        written.append(out_path)
        log(f"{name}: {feats.shape[0]} masks -> {out_path}")
    return written
