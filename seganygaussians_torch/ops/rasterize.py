"""Public rasterization API.

Counterpart of ``seganygaussians_tpu/ops/rasterize.py``.  One pipeline covers
every variant: the channel count is a parameter, so RGB (C = 3), RGB + depth
and mask (extra alpha-composited channels) and 32-dim affinity features are
the same call.

  preprocess (projection.py) — per-Gaussian projection, culling, tile rects
                               (per-row intervals with ``row_footprints``),
                               SH colors; the kernel pair of
                               csrc/preprocess.cu on CUDA tensors
  binning    (binning.py)    — depth sort, slot expansion, (tile, depth) sort;
                               analytic destinations on ``cuda_sortfree``
  blend      (blend_cuda.py on CUDA tensors, blend.py otherwise)

Everything is differentiable.  On CUDA tensors the preprocess and the
blend run forward and backward on the Hopper kernels (``csrc/preprocess.cu``,
``csrc/blend_fwd.cu``, ``csrc/blend_bwd.cu``), with no fallback to autograd
through the plain versions; on CPU tensors, and on any device with the
``torch`` backend, autograd runs through ``projection.py``, ``sh.py`` and
``blend.py``.  ``ndc_offset`` is the
densification gradient input: pass zeros and differentiate with respect to
it.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from seganygaussians_torch.ops import blend as blend_torch
from seganygaussians_torch.ops import blend_cuda
from seganygaussians_torch.ops.binning import expand_slots, plan_instances
from seganygaussians_torch.ops.camera import CameraParams
from seganygaussians_torch.ops.projection import preprocess
from seganygaussians_torch.utils import tracing

BACKENDS = ("auto", "cuda", "cuda_sortfree", "torch")


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    tile_size: int = 16
    capacity: int = 1 << 18  # instance budget (tile-overlap count)
    # "auto": the CUDA kernels (preprocess and blend) for CUDA tensors, the
    # plain versions for CPU tensors; "cuda": the kernels (CUDA tensors only);
    # "cuda_sortfree": the sort-free plan (binning.plan_instances), then as
    # "auto"; "torch": the plain versions on any device.
    backend: str = "auto"
    scale_modifier: float = 1.0
    # Per-tile-row ellipse footprints: fewer instances, the same image, a
    # two-level expansion (ops/binning.py:_expand_slots_rows).
    row_footprints: bool = False


class RasterOutput(NamedTuple):
    color: torch.Tensor  # (H, W, C)
    extra: Optional[torch.Tensor]  # (H, W, E) alpha-composited extra channels
    final_t: torch.Tensor  # (H, W)
    n_contrib: torch.Tensor  # (H, W) int32
    radii: torch.Tensor  # (N,) int32 (0 ⇒ culled; the visibility filter)
    overflow: bool  # instance capacity exceeded


def _select_backend(backend: str, device: torch.device) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(f"backend 'cuda' needs CUDA tensors, got {device}")
    return backend


def rasterize(
    means3d: torch.Tensor,  # (N, 3)
    opacities: torch.Tensor,  # (N,) activated
    camera: CameraParams,
    colors: Optional[torch.Tensor] = None,  # (N, C) precomputed
    shs: Optional[torch.Tensor] = None,  # (N, 3, (deg+1)**2)
    sh_degree: int = 0,
    scales: Optional[torch.Tensor] = None,  # (N, 3) activated
    rotations: Optional[torch.Tensor] = None,  # (N, 4) normalized quats
    cov3d_precomp: Optional[torch.Tensor] = None,  # (N, 6)
    extra: Optional[torch.Tensor] = None,  # (N, E) extra blend channels
    with_depth: bool = False,
    bg: Optional[torch.Tensor] = None,
    ndc_offset: Optional[torch.Tensor] = None,  # (N, 2) zeros; grad target
    active_mask: Optional[torch.Tensor] = None,  # (N,) bool; False ⇒ culled
    config: RasterConfig = RasterConfig(),
) -> RasterOutput:
    """Tile rasterization of 3D Gaussians.

    Exactly one of ``colors`` / ``shs`` must be given.  ``extra`` channels are
    alpha-composited with zero background (depth = Σ dᵢ·αᵢ·Tᵢ, mask =
    Σ mᵢ·αᵢ·Tᵢ).  The result lies on ``means3d``'s device.
    """
    with tracing.span("blend_glue"):
        if (colors is None) == (shs is None):
            raise ValueError("provide exactly one of colors/shs")
        device = means3d.device
        backend = _select_backend(config.backend, device)

        prep = preprocess(
            means3d,
            camera,
            scales=scales,
            rotations=rotations,
            cov3d_precomp=cov3d_precomp,
            scale_modifier=config.scale_modifier,
            tile_size=config.tile_size,
            active_mask=active_mask,
            opacities=opacities,
            row_footprints=config.row_footprints,
            shs=shs,
            sh_degree=sh_degree,
            plain=backend == "torch",
        )

        means2d = prep.means2d
        if ndc_offset is not None:
            # ndc2Pix is affine: pix(ndc + δ) = pix(ndc) + δ·S/2.
            with tracing.sync("ndc_scale"):
                scale_vec = torch.tensor(
                    [camera.width * 0.5, camera.height * 0.5], dtype=means2d.dtype, device=device
                )
            means2d = means2d + ndc_offset * scale_vec

        if colors is None:
            colors = prep.colors

        channels = [colors]
        if with_depth:
            channels.append(prep.depths[:, None])
        if extra is not None:
            channels.append(extra)
        all_colors = torch.cat(channels, dim=-1) if len(channels) > 1 else colors

        c_rgb = colors.shape[-1]
        if bg is None:
            bg = torch.zeros((c_rgb,), dtype=torch.float32, device=device)
        bg_full = torch.cat(
            [bg, torch.zeros((all_colors.shape[-1] - c_rgb,), dtype=bg.dtype, device=device)]
        )

        ts = config.tile_size
        grid_x = (camera.width + ts - 1) // ts
        grid_y = (camera.height + ts - 1) // ts

        if backend == "cuda_sortfree":
            plan = plan_instances(prep, grid_x, grid_y, config.capacity)
        else:
            plan = expand_slots(prep, grid_x, grid_y, config.capacity)
        # The backward's edge (b): the gradient reaches the Gaussians.
        means2d, conics, opacities, all_colors = tracing.mark(
            "gaussians", "raster", means2d, prep.conics, opacities, all_colors)
        perm = plan.depth_perm
        means2d_d = means2d[perm]
        conics_d = conics[perm]
        opacities_d = opacities[perm]
        colors_d = all_colors[perm]
        fields = (
            means2d_d[:, 0], means2d_d[:, 1],
            conics_d[:, 0], conics_d[:, 1], conics_d[:, 2],
            opacities_d,
        ) + tuple(colors_d.unbind(-1))
        # blend_fused and blend_sortfree run the kernels on CUDA tensors, the
        # plain version on CPU tensors.
        if backend == "cuda_sortfree":
            out = blend_cuda.blend_sortfree(plan.sorted_gauss, plan.tile_starts, fields, bg_full,
                                            grid_x, grid_y, ts)
        else:
            blend_fn = (blend_cuda.blend_fused_plain if backend == "torch"
                        else blend_cuda.blend_fused)
            out = blend_fn(plan.slot_rank, plan.slot_tile, fields, bg_full, grid_x, grid_y, ts)

        def to_image(x):
            return blend_torch.tiles_to_image(x, grid_x, grid_y, ts, camera.width, camera.height)

        # The backward's edge (a): the gradient reaches the image.
        (img,) = tracing.mark("image", "loss", to_image(out.tiles))
        final_t = to_image(out.final_t[:, :, None])[..., 0]
        n_contrib = to_image(out.n_contrib[:, :, None])[..., 0]

        return RasterOutput(
            color=img[..., :c_rgb],
            extra=img[..., c_rgb:] if all_colors.shape[-1] > c_rgb else None,
            final_t=final_t,
            n_contrib=n_contrib,
            radii=prep.radii,
            overflow=plan.overflow,
        )
