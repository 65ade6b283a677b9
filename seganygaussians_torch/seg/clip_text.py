"""Open-vocabulary CLIP querying.

Counterpart of ``seganygaussians_tpu/seg/clip_text.py``.  The scoring math
(``get_relevancy``, template averaging, the score → 3D-mask lifting) is plain
tensor code over embeddings from any source: the per-mask
``clip_features/<image>.pt`` sidecars, or a live encoder.  The encoder
(OpenCLIP ViT-B/16 laion2b in the reference, HF ``transformers`` CLIP from
local files as the fallback) is pluggable through :class:`ClipEncoder`; both
backends are imported only when asked for, and neither reaches the network.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from seganygaussians_torch.seg.queries import normalize
from seganygaussians_torch.utils.precision import ieee_fp32_matmul

# Canonical negatives (`clip_utils/clip_utils.py:16`).
CANONICAL_NEGATIVES = ("object", "things", "stuff", "texture")

# The reference's template bank, 80 prompts (`clip_utils/__init__.py:7-88`).
DEFAULT_TEMPLATE = [
    "a bad photo of a {}.", "a photo of many {}.", "a sculpture of a {}.",
    "a photo of the hard to see {}.", "a low resolution photo of the {}.",
    "a rendering of a {}.", "graffiti of a {}.", "a bad photo of the {}.",
    "a cropped photo of the {}.", "a tattoo of a {}.", "the embroidered {}.",
    "a photo of a hard to see {}.", "a bright photo of a {}.",
    "a photo of a clean {}.", "a photo of a dirty {}.",
    "a dark photo of the {}.", "a drawing of a {}.", "a photo of my {}.",
    "the plastic {}.", "a photo of the cool {}.", "a close-up photo of a {}.",
    "a black and white photo of the {}.", "a painting of the {}.",
    "a painting of a {}.", "a pixelated photo of the {}.",
    "a sculpture of the {}.", "a bright photo of the {}.",
    "a cropped photo of a {}.", "a plastic {}.", "a photo of the dirty {}.",
    "a jpeg corrupted photo of a {}.", "a blurry photo of the {}.",
    "a photo of the {}.", "a good photo of the {}.", "a rendering of the {}.",
    "a {} in a video game.", "a photo of one {}.", "a doodle of a {}.",
    "a close-up photo of the {}.", "a photo of a {}.", "the origami {}.",
    "the {} in a video game.", "a sketch of a {}.", "a doodle of the {}.",
    "a origami {}.", "a low resolution photo of a {}.", "the toy {}.",
    "a rendition of the {}.", "a photo of the clean {}.",
    "a photo of a large {}.", "a rendition of a {}.", "a photo of a nice {}.",
    "a photo of a weird {}.", "a blurry photo of a {}.", "a cartoon {}.",
    "art of a {}.", "a sketch of the {}.", "a embroidered {}.",
    "a pixelated photo of a {}.", "itap of the {}.",
    "a jpeg corrupted photo of the {}.", "a good photo of a {}.",
    "a plushie {}.", "a photo of the nice {}.", "a photo of the small {}.",
    "a photo of the weird {}.", "the cartoon {}.", "art of the {}.",
    "a drawing of the {}.", "a photo of the large {}.",
    "a black and white photo of a {}.", "the plushie {}.",
    "a dark photo of a {}.", "itap of a {}.", "graffiti of the {}.",
    "a toy {}.", "itap of my {}.", "a photo of a cool {}.",
    "a photo of a small {}.", "a tattoo of the {}.",
]


def _pairwise_lowest(pos: torch.Tensor, negs: torch.Tensor) -> torch.Tensor:
    """min over negatives of softmax(10·[pos, neg])[0]; ``pos`` broadcasts
    against ``negs`` over the last (negatives) axis."""
    pair = torch.stack(torch.broadcast_tensors(pos, negs), dim=-1)
    soft = torch.softmax(10.0 * pair, dim=-1)
    return torch.amin(soft[..., 0], dim=-1)


def get_relevancy(
    embeds: torch.Tensor,  # (N, C) image/mask embeddings (need not be normed)
    pos_embeds: torch.Tensor,  # (P, C) normalised positive text embeddings
    neg_embeds: torch.Tensor,  # (Q, C) normalised negative text embeddings
    positive_id: int = 0,
) -> torch.Tensor:
    """(N, 2) [score, 1-score]: 10×-temperature pairwise softmax against each
    negative, min over negatives."""
    with ieee_fp32_matmul():
        pos = embeds @ pos_embeds[positive_id]  # (N,)
        negs = embeds @ neg_embeds.T  # (N, Q)
    lowest = _pairwise_lowest(pos[:, None], negs)
    return torch.stack([lowest, 1.0 - lowest], dim=-1)


def get_relevancy_multi(
    embeds: torch.Tensor, pos_embeds: torch.Tensor, neg_embeds: torch.Tensor
) -> torch.Tensor:
    """(N, P, 2) relevancy per positive."""
    with ieee_fp32_matmul():
        pos = embeds @ pos_embeds.T  # (N, P)
        negs = embeds @ neg_embeds.T  # (N, Q)
    lowest = _pairwise_lowest(pos[:, :, None], negs[:, None, :])  # (N, P)
    return torch.stack([lowest, 1.0 - lowest], dim=-1)


def get_scores(
    mask_embeds: torch.Tensor,  # (N, C) per-SAM-mask CLIP features
    pos_embeds: torch.Tensor,
    neg_embeds: torch.Tensor,
) -> torch.Tensor:
    """(N,) per-mask relevancy score."""
    return get_relevancy(mask_embeds, normalize(pos_embeds), normalize(neg_embeds))[:, 0]


def get_segmentation_scores(mask_embeds: torch.Tensor, pos_embeds: torch.Tensor) -> torch.Tensor:
    """(N, P) raw cosine scores."""
    with ieee_fp32_matmul():
        return mask_embeds @ normalize(pos_embeds).T


def scores_to_pixel_map(
    scores: torch.Tensor,  # (K,) per-mask scores
    masks: torch.Tensor,  # (K, H, W)
) -> torch.Tensor:
    """Per-pixel score: the mask-weighted mean over the masks covering it."""
    with ieee_fp32_matmul():
        num = torch.einsum("k,khw->hw", scores, masks)
    return num / (torch.sum(masks, dim=0) + 1e-9)


def lift_accumulator(
    views: Sequence,  # objects with .params (CameraParams)
    view_scores: Sequence,  # per-view (h, w) 2D score maps
    state,  # models.gaussians.GaussianState
    config=None,
) -> torch.Tensor:
    """(capacity,) Σ over views of −∂(−Σ score·rendered_mask)/∂m: each view's
    gradient of the negative overlap with respect to the per-Gaussian mask
    values m (at zero) is SUBTRACTED from the sum.  The score map is resized
    to the render as ``jax.image.resize(..., "bilinear")`` does.  On CUDA
    tensors each view is one forward and one backward kernel launch at C = 3
    (the mask expanded to three channels)."""
    from seganygaussians_torch import render as R
    from seganygaussians_torch.ops.rasterize import RasterConfig
    from seganygaussians_torch.seg.language import resize_bilinear

    config = config or RasterConfig()
    device = state.params.xyz.device
    cap = state.alive.shape[0]
    acc = torch.zeros((cap,), dtype=torch.float32, device=device)
    bg = torch.zeros((3,), dtype=torch.float32, device=device)
    for view, score in zip(views, view_scores):
        score = torch.as_tensor(score, dtype=torch.float32, device=device)
        m = torch.zeros((cap,), dtype=torch.float32, device=device, requires_grad=True)
        with torch.enable_grad():
            pkg = R.render_mask(view.params, state, bg, precomputed_mask=m, config=config)
            if pkg["overflow"]:
                raise RuntimeError(f"instance capacity {config.capacity} exceeded while "
                                   "lifting a score map; raise the raster capacity")
            rendered = pkg["mask"]
            target = resize_bilinear(score, tuple(rendered.shape))
            (g,) = torch.autograd.grad(-torch.sum(target * rendered), m)
        acc = acc - g
    return acc


def lift_scores_to_3d(views: Sequence, view_scores: Sequence, state, config=None,
                      threshold: float = 0.0) -> torch.Tensor:
    """2D score maps → per-Gaussian 3D mask by mask-render backprop: the live
    Gaussians whose :func:`lift_accumulator` ends above ``threshold``."""
    return (lift_accumulator(views, view_scores, state, config) > threshold) & state.alive


class _OpenClipImpl:
    """OpenCLIP backend, the reference's tower (ViT-B-16 laion2b_s34b_b88k).
    Reference-made ``clip_features`` sidecars were embedded with it; scores
    against them mean something only with this backend."""

    def __init__(self, model_name: str, pretrained: str, device="cuda"):
        import open_clip

        model, _, _ = open_clip.create_model_and_transforms(model_name, pretrained=pretrained)
        self.device = torch.device(device)
        self.model = model.eval().to(self.device)
        self.tokenizer = open_clip.get_tokenizer(model_name)

    def encode_text(self, prompts: list[str]) -> np.ndarray:
        with torch.no_grad():
            tok = torch.cat([self.tokenizer(p) for p in prompts]).to(self.device)
            out = self.model.encode_text(tok)
        return out.float().cpu().numpy()

    def encode_image(self, images) -> np.ndarray:
        # 224² resize + CLIP normalisation, one crop at a time (crops differ
        # in size).
        mean = torch.tensor([0.48145466, 0.4578275, 0.40821073], device=self.device)
        std = torch.tensor([0.26862954, 0.26130258, 0.27577711], device=self.device)
        batch = []
        for im in images:
            t = torch.as_tensor(np.asarray(im, np.float32), device=self.device)
            t = torch.nn.functional.interpolate(t.permute(2, 0, 1)[None], size=(224, 224),
                                                mode="bilinear", align_corners=False)
            batch.append((t[0] - mean[:, None, None]) / std[:, None, None])
        with torch.no_grad():
            out = self.model.encode_image(torch.stack(batch))
        return out.float().cpu().numpy()


class _HfClipImpl:
    """HF ``transformers`` CLIP from local files only (other weights than the
    reference's laion2b tower: do NOT score reference-made sidecars with it)."""

    def __init__(self, model_name: str, device="cuda"):
        from transformers import CLIPModel, CLIPProcessor

        self.device = torch.device(device)
        self.model = CLIPModel.from_pretrained(model_name, local_files_only=True).to(self.device)
        self.processor = CLIPProcessor.from_pretrained(model_name, local_files_only=True)

    def encode_text(self, prompts: list[str]) -> np.ndarray:
        inputs = self.processor(text=prompts, return_tensors="pt", padding=True).to(self.device)
        with torch.no_grad():
            return self.model.get_text_features(**inputs).cpu().numpy()

    def encode_image(self, images) -> np.ndarray:
        inputs = self.processor(images=list(images), return_tensors="pt").to(self.device)
        with torch.no_grad():
            return self.model.get_image_features(**inputs).cpu().numpy()


class ClipEncoder:
    """Pluggable text/image encoder.

    Backends in the reference's order: OpenCLIP ViT-B-16 laion2b_s34b_b88k
    when ``open_clip`` and its weights are there (needed to score
    reference-made ``clip_features`` sidecars), then HF ``transformers`` CLIP
    from local files.  With ``backend="auto"`` a fall-back to the HF tower is
    announced with a warning: its embeddings do not match laion2b sidecars.
    ``_impl`` is a seam for tests: any object with
    ``encode_text(prompts) -> (P, D)`` and ``encode_image(images) -> (B, D)``
    (un-normalised) plugs in.  ``backend`` names the one in use.  The tower
    runs on the card unless ``device`` names another."""

    def __init__(
        self,
        model_name: str = "ViT-B-16",
        pretrained: str = "laion2b_s34b_b88k",
        hf_model_name: str = "openai/clip-vit-base-patch16",
        backend: str = "auto",
        device="cuda",
        _impl=None,
    ):
        if _impl is not None:
            self.backend = "injected"
            self._impl = _impl
            return
        errors = []
        if backend in ("auto", "open_clip"):
            try:
                self._impl = _OpenClipImpl(model_name, pretrained, device)
                self.backend = "open_clip"
                return
            except Exception as e:  # no open_clip, or no weights
                errors.append(f"open_clip: {e}")
                if backend == "open_clip":
                    raise RuntimeError(
                        "OpenCLIP weights unavailable locally; precompute clip_features "
                        "sidecars offline (get_clip_features flow) and query with those "
                        "embeddings instead"
                    ) from e
        try:
            self._impl = _HfClipImpl(hf_model_name, device)
            self.backend = "hf"
        except Exception as e:  # no transformers, or no local weights
            errors.append(f"hf: {e}")
            raise RuntimeError(
                f"CLIP weights unavailable locally ({'; '.join(errors)}); precompute "
                "clip_features sidecars offline (get_clip_features flow) and query with "
                "those embeddings instead"
            ) from e
        if backend == "auto":
            warnings.warn(
                f"OpenCLIP {model_name} ({pretrained}) unavailable ({errors[0]}); using the HF "
                f"CLIP tower {hf_model_name!r}: its embeddings do not match sidecars made "
                "with the reference's laion2b tower",
                RuntimeWarning, stacklevel=2,
            )

    def encode_text(self, prompts: list[str]) -> np.ndarray:
        out = np.asarray(self._impl.encode_text(prompts), np.float32)
        return out / np.linalg.norm(out, axis=-1, keepdims=True).clip(1e-12)

    def encode_text_with_template(
        self, texts: list[str], template: Optional[list[str]] = None
    ) -> np.ndarray:
        """Template-averaged, normalised text embeddings (P, D)."""
        template = template or DEFAULT_TEMPLATE
        prompts = [t.format(x) for x in texts for t in template]
        emb = self.encode_text(prompts).reshape(len(texts), len(template), -1).mean(axis=1)
        return emb / np.linalg.norm(emb, axis=-1, keepdims=True)

    def encode_image(self, images) -> np.ndarray:
        out = np.asarray(self._impl.encode_image(images), np.float32)
        return out / np.linalg.norm(out, axis=-1, keepdims=True).clip(1e-12)
