"""Similarity queries + 3D segmentation from prompts.

Counterpart of ``seganygaussians_tpu/seg/queries.py``: click similarity,
scale-gated ``segment3d`` and the feature PCA preview.  The products are fp32
matrix products (``torch.matmul``), run in IEEE fp32 whatever the caller's
TF32 setting: every one of them ends in a threshold.
"""

from __future__ import annotations

from typing import Optional

import torch

from seganygaussians_torch.seg.scale_gate import ScaleGateParams, apply_scale_gate
from seganygaussians_torch.utils import tracing
from seganygaussians_torch.utils.precision import ieee_fp32_matmul


def normalize(x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """x / max(‖x‖, eps) along the last axis."""
    with tracing.span("gate"):
        return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(eps)


def gate_features(
    features: torch.Tensor,  # (N, D) raw affinity features
    gate_params: ScaleGateParams,
    scale,  # () quantile-normalised scale in [0, 1]: a float or a tensor
) -> torch.Tensor:
    """Scale-condition features: f ⊙ gate(scale), L2-normalised."""
    with tracing.span("gate"):
        with tracing.sync("gate_scale"):
            s = torch.as_tensor(scale, dtype=torch.float32, device=features.device)
        gates = apply_scale_gate(gate_params, s.reshape(1, 1))[0]  # (D,)
        return normalize(features * gates[None, :])


def click_similarity(
    feature_map: torch.Tensor,  # (H, W, D) rendered (gated + normalised) features
    xy: tuple[int, int],  # click pixel (x, y)
) -> torch.Tensor:
    """(H, W) cosine score map against the clicked pixel's feature."""
    chosen = feature_map[xy[1], xy[0]]  # (D,)
    with ieee_fp32_matmul():
        return torch.einsum("hwc,c->hw", feature_map, chosen)


def similarity_to_prompts(
    gated_gaussian_features: torch.Tensor,  # (N, D) normalised
    prompt_features: torch.Tensor,  # (P, D) normalised query vectors
) -> torch.Tensor:
    """(N,) largest cosine similarity to any prompt."""
    with ieee_fp32_matmul():
        sims = gated_gaussian_features @ prompt_features.T  # (N, P)
    return torch.amax(sims, dim=-1)


def segment3d(
    gaussian_features: torch.Tensor,  # (N, D) raw per-Gaussian features
    gate_params: ScaleGateParams,
    scale,
    prompt_features: torch.Tensor,  # (P, D), e.g. clicked-pixel features
    threshold: float = 0.75,
    alive: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(N,) bool 3D mask: scale-gated per-Gaussian similarity > threshold
    (0.75 for a point prompt, 0.85 on the language path).  With ``alive``
    over a capacity-padded scene state (live rows first), the mask is padded
    to its length and restricted to it."""
    with tracing.span("gate"):
        gated = gate_features(gaussian_features, gate_params, scale)
        score = similarity_to_prompts(gated, normalize(prompt_features))
        return pad_to_alive(score > threshold, alive)


def pad_to_alive(mask: torch.Tensor, alive: Optional[torch.Tensor]) -> torch.Tensor:
    """``mask`` over the feature field's N rows → over the scene state's
    capacity, AND ``alive``."""
    if alive is None:
        return mask
    if alive.shape[0] > mask.shape[0]:
        mask = torch.nn.functional.pad(mask, (0, alive.shape[0] - mask.shape[0]))
    return mask & alive


def feature_pca(
    features: torch.Tensor,  # (N, D)
    n_components: int = 3,
    generator: Optional[torch.Generator] = None,
    sample: int = 10_000,
    indices: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(D, n_components) PCA projection for feature display, on a random
    subset of ``sample`` rows (drawn with ``generator``, or the given
    ``indices``) when there are more.  Singular vectors are defined up to
    sign."""
    n = features.shape[0]
    if indices is None and generator is not None and n > sample:
        indices = torch.randperm(n, generator=generator, device=generator.device)[:sample]
    x = features if indices is None else features[indices.to(features.device)]
    x = x - torch.mean(x, dim=0, keepdim=True)
    # Right singular vectors of the (S, D) matrix are the principal axes.
    _, _, vh = torch.linalg.svd(x, full_matrices=False)
    return vh[:n_components].T


def apply_pca(feature_map: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """(..., D) → (..., 3), each channel scaled to [0, 1] for display."""
    with ieee_fp32_matmul():
        y = feature_map @ proj
    flat = y.reshape(-1, y.shape[-1])
    lo, hi = flat.amin(dim=0), flat.amax(dim=0)
    return (y - lo) / torch.clamp_min(hi - lo, 1e-9)
