"""Per-Gaussian screen-space preprocess (projection, EWA cov2D, tile rects).

Counterpart of ``seganygaussians_tpu/ops/projection.py:preprocess`` on its
default path: one vectorised pass over N Gaussians with validity masks.

  * near-cull at view-space z <= 0.2
  * perspective divide with eps 1e-7
  * EWA J·W·Σ·Wᵀ·Jᵀ with t.x/t.y clamped to ±1.3·tanfov, +0.3 low-pass
  * radius = ceil(3·sqrt(max eigenvalue)) (the reference's 3σ radii)
  * exact α ≥ 1/255 tile rects when opacities are given, via getRect
  * with ``row_footprints``, per-tile-row x-intervals of that ellipse
    (:func:`_row_intervals`) and the exact count of the tiles they cover
  * ndc2Pix(v, S) = ((v+1)·S − 1)/2

The 4×4 and 3×3 products are written out elementwise, and so are the row
intervals, so they stay in full fp32 whatever the card's TF32 settings are.
Each small sum is taken term by term, left to right, ((a0 + a1) + a2) + a3,
not by a reduction whose order is PyTorch's to choose: the preprocess kernel
follows the same order, so that its floats equal this path's.

On CUDA tensors the whole stage, with the SH colors, is the kernel pair of
``csrc/preprocess.cu`` (``ops/preprocess_cuda.py``), differentiable through
its backward kernel; on CPU tensors, and with ``plain``, it is the plain path
below, differentiable by autograd, and ``eval_sh_color`` for the colors.  The row intervals are
PyTorch on both (no-grad, after the rects).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from seganygaussians_torch.ops.camera import CameraParams
from seganygaussians_torch.ops.sh import eval_sh_color
from seganygaussians_torch.ops.transforms import build_covariance_3d
from seganygaussians_torch.utils import tracing


class Preprocessed(NamedTuple):
    """Per-Gaussian screen-space quantities (all shaped (N, ...))."""

    means2d: torch.Tensor  # (N, 2) pixel coordinates
    depths: torch.Tensor  # (N,) view-space z
    conics: torch.Tensor  # (N, 3) inverse 2D covariance (a, b, c)
    radii: torch.Tensor  # (N,) int32 screen-space radius (0 ⇒ culled)
    rect_min: torch.Tensor  # (N, 2) int32 tile rect (x, y) inclusive-min
    rect_max: torch.Tensor  # (N, 2) int32 tile rect exclusive-max
    tiles_touched: torch.Tensor  # (N,) int32
    valid: torch.Tensor  # (N,) bool
    # (N, grid_y) int32 x0_tile | width << 10 per tile row, with row_footprints
    row_pack: Optional[torch.Tensor] = None
    colors: Optional[torch.Tensor] = None  # (N, C) SH colors, when shs are given


def _row_vec_mul(p: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(N, K) @ (K, J) as elementwise products summed left to right over K
    (full fp32 on every device, in an order fixed by the code alone)."""
    out = p[:, :1] * m[0]
    for k in range(1, m.shape[0]):
        out = out + p[:, k:k + 1] * m[k]
    return out


def project_points(
    means3d: torch.Tensor, world_view: torch.Tensor, full_proj: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Project to NDC and view space (row-vector convention).

    Returns (p_proj (N,3) NDC, p_view (N,3) view-space).
    """
    hom = torch.cat([means3d, torch.ones_like(means3d[:, :1])], dim=-1)
    p_hom = _row_vec_mul(hom, full_proj)
    p_w = 1.0 / (p_hom[:, 3:4] + 1e-7)
    p_proj = p_hom[:, :3] * p_w
    p_view = _row_vec_mul(hom, world_view)
    return p_proj, p_view[:, :3]


def compute_cov2d(
    p_view: torch.Tensor,
    cov3d: torch.Tensor,
    camera: CameraParams,
    world_view: torch.Tensor,
) -> torch.Tensor:
    """EWA splatting 2D covariance (packed (N,3): xx, xy, yy)."""
    fx, fy = camera.focal_x, camera.focal_y
    tx, ty, tz = p_view.unbind(-1)
    limx = 1.3 * camera.tan_fovx
    limy = 1.3 * camera.tan_fovy
    tz_safe = torch.where(tz == 0.0, torch.full_like(tz, 1e-6), tz)
    tx = torch.clamp(tx / tz_safe, -limx, limx) * tz
    ty = torch.clamp(ty / tz_safe, -limy, limy) * tz
    inv_z = 1.0 / tz_safe
    inv_z2 = inv_z * inv_z

    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2

    R = world_view[:3, :3].T  # column-vector rotation world→view
    m0 = j00[:, None] * R[0] + j02[:, None] * R[2]  # (N, 3)
    m1 = j11[:, None] * R[1] + j12[:, None] * R[2]

    xx, xy, xz, yy, yz, zz = cov3d.unbind(-1)

    def sym_mul(m):  # Σ @ m for row vector m (N,3) → (N,3)
        return torch.stack(
            [
                xx * m[:, 0] + xy * m[:, 1] + xz * m[:, 2],
                xy * m[:, 0] + yy * m[:, 1] + yz * m[:, 2],
                xz * m[:, 0] + yz * m[:, 1] + zz * m[:, 2],
            ],
            dim=-1,
        )

    def dot(a, b):  # summed left to right
        return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]

    s_m0 = sym_mul(m0)
    s_m1 = sym_mul(m1)
    c_xx = dot(m0, s_m0) + 0.3
    c_xy = dot(m0, s_m1)
    c_yy = dot(m1, s_m1) + 0.3
    return torch.stack([c_xx, c_xy, c_yy], dim=-1)


def ndc2pix(v: torch.Tensor, size: int) -> torch.Tensor:
    return ((v + 1.0) * size - 1.0) * 0.5


def _tile_index(v: torch.Tensor, hi: int) -> torch.Tensor:
    """floor(v) clipped to [0, hi] as int32.  The clip happens in float, so
    values too large for int32 cannot wrap before it (the getRect min uses C
    truncation toward zero; negative operands clip to 0 either way)."""
    return torch.clamp(torch.floor(v), 0, hi).to(torch.int32)


def _row_intervals(mx, my, conics, tau, rx0, rx1, ry0, ry1, grid_y: int, tile_size: int):
    """Per-tile-row x-intervals of the α ≥ 1/255 ellipse, (N, grid_y).

    The contributing set {q(dx, dy) ≤ 2τ}, q = a·dx² + 2b·dx·dy + c·dy²
    (conic (a, b, c), τ = ln(255·opa)), meets the pixel-row band
    dy ∈ [dyl, dyh] in an x-interval.  Its upper boundary
    x₊(dy) = (−b·dy + √D)/a with D = 2aτ − det·dy² is concave, so the
    interval's max is x₊ at the critical point dy* = −b·√(2τ/(c·det))
    clipped to the band; the lower boundary follows from x₋(dy) = −x₊(−dy).
    A ±1 px margin absorbs rounding, as the rect's does.  Rows outside the
    rect get width 0; a degenerate conic gets the rect's full width.

    Returns (row_pack int32 (N, grid_y): x0_tile | width << 10, the exact
    tiles_touched (N,) int32)."""
    ts = tile_size
    a, b, c = conics[:, 0:1], conics[:, 1:2], conics[:, 2:3]
    det = a * c - b * b
    ok = (det > 0.0) & (a > 0.0) & (c > 0.0)
    one = torch.ones_like(det)
    det_s, a_s, c_s = torch.where(ok, det, one), torch.where(ok, a, one), torch.where(ok, c, one)
    tau = torch.clamp_min(tau[:, None], 0.0)

    ty = torch.arange(grid_y, dtype=torch.float32, device=mx.device)[None, :]
    dyl = ty * ts - my[:, None]  # first pixel-centre offset of each row
    dyh = dyl + (ts - 1)  # last

    dmax = torch.sqrt(torch.clamp_min(2.0 * a_s * tau / det_s, 0.0))
    dy_star = -torch.sign(b) * torch.abs(b) * torch.sqrt(
        torch.clamp_min(2.0 * tau / (c_s * det_s), 0.0)
    )

    def xmax_over(lo_in, hi_in):
        lo = torch.maximum(lo_in, -dmax)
        hi = torch.minimum(hi_in, dmax)
        dyc = torch.minimum(torch.maximum(dy_star, lo), hi)
        d_val = torch.clamp_min(2.0 * a_s * tau - det_s * dyc * dyc, 0.0)
        return (-b * dyc + torch.sqrt(d_val)) / a_s, lo <= hi

    x_hi, nonempty = xmax_over(dyl, dyh)
    x_lo = -xmax_over(-dyh, -dyl)[0]

    ty_i = torch.arange(grid_y, dtype=torch.int32, device=mx.device)[None, :]
    x0, x1 = rx0[:, None], rx1[:, None]
    in_rows = (ty_i >= ry0[:, None]) & (ty_i < ry1[:, None])
    live = in_rows & nonempty & ok

    def tile_col(v):  # floor(v) as int32, clipped to the rect's columns
        v = torch.clamp(torch.floor(v), -(2 ** 30), 2 ** 30).to(torch.int32)
        return torch.minimum(torch.maximum(v, x0), x1)

    tx0 = tile_col((mx[:, None] + x_lo - 1.0) / ts)
    tx1 = tile_col((mx[:, None] + x_hi + 1.0 + ts - 1) / ts)
    tx0 = torch.where(ok, tx0, x0)
    zero = torch.zeros_like(tx0)
    w = torch.where(live, torch.clamp_min(tx1 - tx0, 0), zero)
    w = torch.where(in_rows & ~ok, torch.clamp_min(x1 - x0, 0).expand_as(w), w)
    return tx0 | (w << 10), torch.sum(w, dim=-1, dtype=torch.int32)


def _preprocess_plain(means3d, camera, scales, rotations, cov3d_precomp, scale_modifier,
                      tile_size, active_mask, opacities) -> Preprocessed:
    """:func:`preprocess` on any device, without the row intervals and colors:
    the CPU path, and the forward kernel's plain counterpart."""
    if cov3d_precomp is None:
        cov3d = build_covariance_3d(scales, rotations, scale_modifier)
    else:
        cov3d = cov3d_precomp

    world_view, full_proj, _ = camera.tensors(means3d.device)
    p_proj, p_view = project_points(means3d, world_view, full_proj)
    depths = p_view[:, 2]
    in_front = depths > 0.2

    cov2d = compute_cov2d(p_view, cov3d, camera, world_view)
    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] * cov2d[:, 1]
    det_valid = det != 0.0
    det_inv = 1.0 / torch.where(det_valid, det, torch.ones_like(det))
    conics = torch.stack(
        [cov2d[:, 2] * det_inv, -cov2d[:, 1] * det_inv, cov2d[:, 0] * det_inv],
        dim=-1,
    )

    mid = 0.5 * (cov2d[:, 0] + cov2d[:, 2])
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    lambda1 = mid + disc
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lambda1, 1e-12)))

    mx = ndc2pix(p_proj[:, 0], camera.width)
    my = ndc2pix(p_proj[:, 1], camera.height)
    means2d = torch.stack([mx, my], dim=-1)

    grid_x = (camera.width + tile_size - 1) // tile_size
    grid_y = (camera.height + tile_size - 1) // tile_size

    # Rects and radii are structural (integers), so no gradient flows here.
    with torch.no_grad():
        if opacities is None:
            rad_x = rad_y = radius_f
            opa_visible = torch.ones_like(in_front)
        else:
            opa = opacities.detach().reshape(-1)
            opa_visible = opa * 255.0 > 1.0
            e = torch.sqrt(
                torch.clamp_min(2.0 * torch.log(torch.clamp_min(opa, 1e-12) * 255.0), 0.0)
            )
            rad_x = torch.minimum(
                e * torch.sqrt(torch.clamp_min(cov2d[:, 0], 0.0)) + 1.0, radius_f
            )
            rad_y = torch.minimum(
                e * torch.sqrt(torch.clamp_min(cov2d[:, 2], 0.0)) + 1.0, radius_f
            )

        rx0 = _tile_index((mx - rad_x) / tile_size, grid_x)
        ry0 = _tile_index((my - rad_y) / tile_size, grid_y)
        rx1 = _tile_index((mx + rad_x + tile_size - 1) / tile_size, grid_x)
        ry1 = _tile_index((my + rad_y + tile_size - 1) / tile_size, grid_y)
        num_tiles = (rx1 - rx0) * (ry1 - ry0)

        # Radii/visibility use the 3σ circle rect regardless of opacity.
        r3x0 = _tile_index((mx - radius_f) / tile_size, grid_x)
        r3y0 = _tile_index((my - radius_f) / tile_size, grid_y)
        r3x1 = _tile_index((mx + radius_f + tile_size - 1) / tile_size, grid_x)
        r3y1 = _tile_index((my + radius_f + tile_size - 1) / tile_size, grid_y)
        visible = in_front & det_valid & ((r3x1 - r3x0) * (r3y1 - r3y0) > 0)
        if active_mask is not None:
            visible = visible & active_mask
        valid = visible & (num_tiles > 0) & opa_visible
        radii = torch.where(visible, radius_f, torch.zeros_like(radius_f)).to(torch.int32)
        tiles_touched = torch.where(valid, num_tiles, torch.zeros_like(num_tiles))

    return Preprocessed(
        means2d=means2d,
        depths=depths,
        conics=conics,
        radii=radii,
        rect_min=torch.stack([rx0, ry0], dim=-1),
        rect_max=torch.stack([rx1, ry1], dim=-1),
        tiles_touched=tiles_touched.to(torch.int32),
        valid=valid,
    )


def _with_row_footprints(prep: Preprocessed, opacities, camera, tile_size: int) -> Preprocessed:
    """``prep`` with each tile row of its rects narrowed to the ellipse's
    interval (:func:`_row_intervals`), no-grad."""
    grid_y = (camera.height + tile_size - 1) // tile_size
    with torch.no_grad():
        opa = opacities.detach().reshape(-1)
        tau = torch.log(torch.clamp_min(opa, 1e-12) * 255.0)
        row_pack, num_tiles = _row_intervals(
            prep.means2d[:, 0], prep.means2d[:, 1], prep.conics, tau, prep.rect_min[:, 0],
            prep.rect_max[:, 0], prep.rect_min[:, 1], prep.rect_max[:, 1], grid_y, tile_size,
        )
        valid = prep.valid & (num_tiles > 0)
        row_pack = torch.where(valid[:, None], row_pack, torch.zeros_like(row_pack))
        tiles_touched = torch.where(valid, num_tiles, torch.zeros_like(num_tiles))
    return prep._replace(valid=valid, tiles_touched=tiles_touched.to(torch.int32),
                         row_pack=row_pack)


def preprocess(
    means3d: torch.Tensor,
    camera: CameraParams,
    scales: Optional[torch.Tensor] = None,
    rotations: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
    scale_modifier: float = 1.0,
    tile_size: int = 16,
    active_mask: Optional[torch.Tensor] = None,
    opacities: Optional[torch.Tensor] = None,
    row_footprints: bool = False,
    shs: Optional[torch.Tensor] = None,
    sh_degree: int = 0,
    plain: bool = False,
) -> Preprocessed:
    """Vectorised projection + culling + tile-rect stage.

    ``active_mask`` (N,) bool culls rows entirely (dead capacity slots).
    ``opacities`` (N,) activated opacities give the exact footprint of the
    α ≥ 1/255 ellipse, |dx| ≤ e·√cov_xx, |dy| ≤ e·√cov_yy with
    e = √(2·ln(255·opa)), capped by the 3σ circle; the reported ``radii``
    keep the reference's 3σ semantics.  ``row_footprints`` (with
    ``opacities``) narrows each tile row of the rect to the ellipse's
    interval: ``row_pack`` holds the intervals and ``tiles_touched`` counts
    their tiles.  ``shs`` (N, C, K) with ``sh_degree`` give ``colors``, the
    view-dependent SH colors of :func:`ops.sh.eval_sh_color`.  ``plain``
    takes the plain path on CUDA tensors too (``RasterConfig.backend ==
    "torch"``).
    """
    with tracing.span("preprocess"):
        if cov3d_precomp is None and (scales is None or rotations is None):
            raise ValueError("preprocess needs scales and rotations, or cov3d_precomp")
        if means3d.is_cuda and not plain:
            from seganygaussians_torch.ops import preprocess_cuda

            (means2d, depths, conics, colors, radii, rect_min, rect_max, tiles_touched,
             valid) = preprocess_cuda.preprocess_fused(
                means3d, camera, scales, rotations, cov3d_precomp, scale_modifier, tile_size,
                active_mask, opacities, shs, sh_degree)
            prep = Preprocessed(means2d, depths, conics, radii, rect_min, rect_max,
                                tiles_touched, valid, colors=colors)
        else:
            prep = _preprocess_plain(means3d, camera, scales, rotations, cov3d_precomp,
                                     scale_modifier, tile_size, active_mask, opacities)
            if shs is not None:
                _, _, cam_center = camera.tensors(means3d.device)
                prep = prep._replace(colors=eval_sh_color(sh_degree, shs, means3d, cam_center))
        if opacities is not None and row_footprints:
            prep = _with_row_footprints(prep, opacities, camera, tile_size)
        return prep
