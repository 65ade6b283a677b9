"""Plain PyTorch reference of the 3D Gaussian Splatting rasterizer.

Written from the 3DGS paper and its CUDA rasterizer (Kerbl et al. 2023),
float32 with every product through :class:`~perfbench.reference.arith.Arith`:

* activations of the 59 stored parameters (exp scales, sigmoid opacity,
  normalised quaternions, SH coefficients);
* EWA projection: Σ = R S Sᵀ Rᵀ, cov2D = J W Σ Wᵀ Jᵀ + 0.3 I with the view
  direction clamped to 1.3 tan(fov), 3σ radii, near cull at z ≤ 0.2;
* view-dependent colour: SH to degree 3, + 0.5, clamped at 0;
* tile binning: a Gaussian covers the tiles of its α ≥ 1/255 footprint,
  |dx| ≤ √(2 ln(255 o) cov_xx) + 1 (likewise in y), capped by the 3σ square
  that 3DGS bins over.  A pixel outside that footprint gets α < 1/255 and no
  contribution, so the contributing pairs are 3DGS's own; instances sort by
  (tile, depth);
* the front-to-back blend: α = min(0.99, o·exp(−½ dᵀ Q d)), skipped under
  1/255, a pixel stops before the instance that would bring T under 1e-4,
  C = Σ α T c + T_end·bg.

The blend runs in chunks of whole tiles, so that a full-size frame fits, and
its gradient is autograd recomputed chunk by chunk: the per-instance values
of a chunk are leaves, their gradients are summed into per-Gaussian rows,
and those go back through the projection and SH with autograd.  The
transmittance is a cumulative sum of log(1 − α) in float64 over the chunk,
less its value at the tile's start.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from perfbench.reference.arith import Arith, ieee_fp32

T_EPS = 1e-4
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
# Elements of the largest (pixels × instances) array of a chunk.
CHUNK_ELEMENTS = 1 << 26

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
         -0.4570457994644658, 1.445305721320277, -0.5900435899266435)


class Camera(NamedTuple):
    """Row-vector matrices: p_view = [x y z 1] @ world_view, likewise full_proj."""

    world_view: torch.Tensor  # (4, 4)
    full_proj: torch.Tensor  # (4, 4)
    cam_center: torch.Tensor  # (3,)
    width: int
    height: int
    tan_fovx: float
    tan_fovy: float


def camera_on(cam: dict, device) -> Camera:
    """A camera dict of numpy arrays and numbers (``perfbench/scene.py``) on ``device``."""
    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return Camera(t(cam["world_view"]), t(cam["full_proj"]), t(cam["cam_center"]),
                  int(cam["width"]), int(cam["height"]), float(cam["tan_fovx"]),
                  float(cam["tan_fovy"]))


def activate(params: dict) -> dict:
    """Stored (pre-activation) parameters → what the rasterizer consumes."""
    q = params["rotation"]
    out = {
        "xyz": params["xyz"],
        "scales": torch.exp(params["scaling"]),
        "quats": q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-12),
        "opacity": torch.sigmoid(params["opacity"][:, 0]),
    }
    if "features_dc" in params:
        out["shs"] = torch.cat([params["features_dc"], params["features_rest"]], dim=1)
    return out


def rotation_matrices(q: torch.Tensor) -> torch.Tensor:
    r, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(-1, 3, 3)


class Projected(NamedTuple):
    means2d: torch.Tensor  # (N, 2) pixels
    conics: torch.Tensor  # (N, 3) a, b, c of the inverse 2D covariance
    cov2d: torch.Tensor  # (N, 3) xx, xy, yy
    depths: torch.Tensor  # (N,)
    radii: torch.Tensor  # (N,) float 3σ radius (0: culled)


def project(xyz, scales, quats, cam: Camera, ar: Arith, scale_modifier: float = 1.0) -> Projected:
    n = xyz.shape[0]
    hom = torch.cat([xyz, torch.ones_like(xyz[:, :1])], dim=1)
    p_hom = ar.mm(hom, cam.full_proj)
    p_proj = p_hom[:, :3] / (p_hom[:, 3:4] + 1e-7)
    p_view = ar.mm(hom, cam.world_view)[:, :3]
    # The depth that orders the blend is a sum of four products written out
    # left to right, as 3DGS's preprocess forms it (transformPoint4x3), in
    # every precision: Gaussians at nearly equal depths must not trade places
    # on the order of a sum, which a reduction leaves to the device.
    wv = cam.world_view
    depth = ((xyz[:, 0] * wv[0, 2] + xyz[:, 1] * wv[1, 2]) + xyz[:, 2] * wv[2, 2]) + wv[3, 2]
    front = depth > 0.2
    tz = torch.where(front, depth, torch.ones_like(depth))
    fx = cam.width / (2.0 * cam.tan_fovx)
    fy = cam.height / (2.0 * cam.tan_fovy)
    tx = torch.clamp(p_view[:, 0] / tz, -1.3 * cam.tan_fovx, 1.3 * cam.tan_fovx) * tz
    ty = torch.clamp(p_view[:, 1] / tz, -1.3 * cam.tan_fovy, 1.3 * cam.tan_fovy) * tz
    zero = torch.zeros_like(tz)
    jac = torch.stack([fx / tz, zero, -fx * tx / (tz * tz),
                       zero, fy / tz, -fy * ty / (tz * tz)], dim=-1).reshape(n, 2, 3)
    rot_view = cam.world_view[:3, :3].T  # world → view, column vectors
    m = rotation_matrices(quats) * (scale_modifier * scales)[:, None, :]
    sigma = ar.mm(m, m.transpose(1, 2))
    t = ar.mm(jac, rot_view.expand(n, 3, 3))
    cov = ar.mm(ar.mm(t, sigma), t.transpose(1, 2))
    cxx, cxy, cyy = cov[:, 0, 0] + 0.3, cov[:, 0, 1], cov[:, 1, 1] + 0.3
    det = cxx * cyy - cxy * cxy
    ok = front & (det != 0)
    det_s = torch.where(ok, det, torch.ones_like(det))
    conics = torch.stack([cyy / det_s, -cxy / det_s, cxx / det_s], dim=-1)
    mid = 0.5 * (cxx + cyy)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam, 1e-12))).detach()
    means2d = torch.stack([((p_proj[:, 0] + 1.0) * cam.width - 1.0) * 0.5,
                           ((p_proj[:, 1] + 1.0) * cam.height - 1.0) * 0.5], dim=-1)
    return Projected(means2d, conics, torch.stack([cxx, cxy, cyy], -1), depth,
                     torch.where(ok, radius, torch.zeros_like(radius)))


def sh_colors(shs, xyz, cam: Camera, degree: int, ar: Arith) -> torch.Tensor:
    """(N, K, 3) coefficients → (N, 3) colours along the view direction."""
    d = xyz - cam.cam_center[None, :]
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp_min(1e-12)
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    basis = [torch.full_like(x, SH_C0)]
    if degree > 0:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        basis += [SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2 * zz - xx - yy),
                  SH_C2[3] * xz, SH_C2[4] * (xx - yy)]
    if degree > 2:
        basis += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * xy * z,
                  SH_C3[2] * y * (4 * zz - xx - yy), SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                  SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
                  SH_C3[6] * x * (xx - 3 * yy)]
    basis = torch.stack(basis, dim=-1)  # (N, K)
    rgb = ar.einsum("nk,nkc->nc", basis, shs[:, : basis.shape[1]])
    return torch.clamp_min(rgb + 0.5, 0.0)


class Bins(NamedTuple):
    gauss: torch.Tensor  # (M,) int64 Gaussian of each instance, by (tile, depth)
    tile: torch.Tensor  # (M,) int64
    tile_starts: torch.Tensor  # (T + 1,) int64
    grid: tuple  # (grid_x, grid_y, tile_size)


def _tile_floor(v, hi):
    return torch.clamp(torch.floor(v), 0, hi).long()


def bin_tiles(proj: Projected, opacity, width: int, height: int, tile: int = 16,
              alive: Optional[torch.Tensor] = None) -> Bins:
    """Instances of each Gaussian on the tiles of its α ≥ 1/255 footprint,
    sorted by tile and then by depth (ties by index)."""
    with torch.no_grad():
        gx, gy = -(-width // tile), -(-height // tile)
        mx, my = proj.means2d[:, 0], proj.means2d[:, 1]
        r3 = proj.radii
        opa = opacity.detach()
        e = torch.sqrt(torch.clamp_min(2.0 * torch.log(torch.clamp_min(opa, 1e-12) * 255.0), 0.0))
        rx = torch.minimum(e * torch.sqrt(torch.clamp_min(proj.cov2d[:, 0], 0.0)) + 1.0, r3)
        ry = torch.minimum(e * torch.sqrt(torch.clamp_min(proj.cov2d[:, 2], 0.0)) + 1.0, r3)
        x0, x1 = _tile_floor((mx - rx) / tile, gx), _tile_floor((mx + rx + tile - 1) / tile, gx)
        y0, y1 = _tile_floor((my - ry) / tile, gy), _tile_floor((my + ry + tile - 1) / tile, gy)
        s3 = ((_tile_floor((mx + r3 + tile - 1) / tile, gx) - _tile_floor((mx - r3) / tile, gx))
              * (_tile_floor((my + r3 + tile - 1) / tile, gy) - _tile_floor((my - r3) / tile, gy)))
        count = (x1 - x0) * (y1 - y0)
        valid = (r3 > 0) & (s3 > 0) & (count > 0) & (opa * 255.0 > 1.0)
        if alive is not None:
            valid = valid & alive
        key = torch.where(valid, proj.depths.detach(), torch.full_like(opa, math.inf))
        order = torch.sort(key, stable=True).indices[: int(valid.sum())]
        counts = count[order]
        gauss = torch.repeat_interleave(order, counts)
        first = torch.cumsum(counts, 0) - counts
        local = torch.arange(gauss.shape[0], device=gauss.device) - torch.repeat_interleave(
            first, counts)
        w = (x1 - x0)[gauss]
        tiles = (y0[gauss] + local // w) * gx + x0[gauss] + local % w
        tiles, perm = torch.sort(tiles, stable=True)
        starts = torch.searchsorted(tiles, torch.arange(gx * gy + 1, device=tiles.device))
        return Bins(gauss[perm], tiles, starts, (gx, gy, tile))


def _chunks(bins: Bins):
    """[t0, t1) tile ranges whose instances × pixels stay under
    CHUNK_ELEMENTS (a single tile may exceed it)."""
    gx, gy, ts = bins.grid
    per = max(1, CHUNK_ELEMENTS // (ts * ts))
    starts = bins.tile_starts.tolist()
    t0, num = 0, gx * gy
    while t0 < num:
        t1 = t0 + 1
        while t1 < num and starts[t1 + 1] - starts[t0] <= per:
            t1 += 1
        yield t0, t1, starts[t0], starts[t1]
        t0 = t1


def _blend_chunk(bins: Bins, t0, t1, s, e, means2d, conics, opacity, colors, size=None):
    """The chunk's (t1 − t0, P, C) colour, final T, and the visited and
    included pair counts over the pixels inside ``size`` = (width, height);
    per-instance inputs (e − s rows).  Arrays are pixel-major, (P, m), so
    that the running sum over instances is a scan along the inner axis."""
    gx, _, ts = bins.grid
    p = ts * ts
    tile = bins.tile[s:e]
    local = torch.arange(p, device=tile.device)
    px = (local % ts)[:, None] + (tile % gx * ts)[None, :]
    py = (local // ts)[:, None] + (tile // gx * ts)[None, :]
    dx = means2d[:, 0][None, :] - px.float()
    dy = means2d[:, 1][None, :] - py.float()
    a, b, c = conics[:, 0][None, :], conics[:, 1][None, :], conics[:, 2][None, :]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp_max(opacity[None, :] * torch.exp(power), ALPHA_MAX)
    alpha = torch.where((power <= 0) & (alpha >= ALPHA_MIN), alpha, torch.zeros_like(alpha))
    log1m = torch.log1p(-alpha)
    cum = torch.cumsum(log1m.double(), 1)
    seg = tile - t0
    first = bins.tile_starts[t0:t1] - s  # first instance of each tile in the chunk
    base = torch.where((first > 0)[None, :], cum[:, (first - 1).clamp_min(0)],
                       torch.zeros_like(cum[:, :1]))[:, seg]
    t_before = torch.exp((cum - log1m.double() - base).float())
    include = (t_before * (1.0 - alpha) >= T_EPS) & (alpha > 0)
    w = torch.where(include, alpha * t_before, torch.zeros_like(alpha))
    # Each tile's sums over its own instances: (P, L) @ (L, C) in IEEE fp32.
    bounds = (bins.tile_starts[t0:t1 + 1] - s).tolist()
    tiles = list(zip(bounds, bounds[1:]))
    inc_log1m = torch.where(include, log1m, torch.zeros_like(log1m))
    with ieee_fp32():
        rgb = torch.stack([w[:, i:j] @ colors[i:j] for i, j in tiles])
    log_final = torch.stack([inc_log1m[:, i:j].sum(1) for i, j in tiles])
    visited = included = 0
    if size is not None:
        with torch.no_grad():
            inside = (px < size[0]) & (py < size[1])
            visited = ((t_before >= T_EPS) & inside).sum()
            included = (include & inside).sum()
    return rgb, torch.exp(log_final), visited, included


class Frame(NamedTuple):
    image: torch.Tensor  # (H, W, C)
    final_t: torch.Tensor  # (H, W)
    visited: int  # (instance, pixel) pairs evaluated up to each pixel's stop
    included: int  # pairs blended


def _to_image(tiles, bins: Bins, width, height):
    gx, gy, ts = bins.grid
    c = tiles.shape[-1]
    img = tiles.reshape(gy, gx, ts, ts, c).permute(0, 2, 1, 3, 4).reshape(gy * ts, gx * ts, c)
    return img[:height, :width]


def _to_tiles(image, bins: Bins):
    gx, gy, ts = bins.grid
    h, w, c = image.shape
    full = torch.zeros((gy * ts, gx * ts, c), dtype=image.dtype, device=image.device)
    full[:h, :w] = image
    return full.reshape(gy, ts, gx, ts, c).permute(0, 2, 1, 3, 4).reshape(gx * gy, ts * ts, c)


def blend(bins: Bins, means2d, conics, opacity, colors, bg, width, height) -> Frame:
    """The frame, no gradient."""
    gx, gy, ts = bins.grid
    c = colors.shape[1]
    tiles = torch.zeros((gx * gy, ts * ts, c), device=colors.device)
    final_t = torch.ones((gx * gy, ts * ts), device=colors.device)
    visited = included = 0
    with torch.no_grad():
        for t0, t1, s, e in _chunks(bins):
            if e == s:
                continue
            g = bins.gauss[s:e]
            rgb, ft, v, i = _blend_chunk(bins, t0, t1, s, e, means2d[g], conics[g],
                                         opacity[g], colors[g], (width, height))
            tiles[t0:t1], final_t[t0:t1] = rgb, ft
            visited, included = visited + v, included + i
        tiles = tiles + final_t[:, :, None] * bg[None, None, :]
    return Frame(_to_image(tiles, bins, width, height),
                 _to_image(final_t[:, :, None], bins, width, height)[..., 0], int(visited),
                 int(included))


def blend_backward(bins: Bins, means2d, conics, opacity, colors, bg, grad_image):
    """Gradients of Σ grad_image · image with respect to the per-Gaussian
    means2d, conics, opacity and colours (the background held fixed)."""
    g_tiles = _to_tiles(grad_image, bins)
    acc =[torch.zeros_like(x) for x in (means2d, conics, opacity, colors)]
    for t0, t1, s, e in _chunks(bins):
        if e == s:
            continue
        g = bins.gauss[s:e]
        leaves = [x.detach()[g].requires_grad_(True) for x in (means2d, conics, opacity, colors)]
        with torch.enable_grad():
            rgb, final_t, _, _ = _blend_chunk(bins, t0, t1, s, e, *leaves)
            out = rgb + final_t[:, :, None] * bg[None, None, :]
            grads = torch.autograd.grad(out, leaves, g_tiles[t0:t1])
        for a, gr in zip(acc, grads):
            a.index_add_(0, g, gr)
    return acc


def prepare(params: dict, cam: Camera, ar: Arith, sh_degree: int = 3, colors=None, bg=None,
            tile: int = 16, alive=None) -> tuple:
    """(bins, the differentiable per-Gaussian blend inputs, bg) of activated
    ``params`` (``activate``)."""
    proj = project(params["xyz"], params["scales"], params["quats"], cam, ar)
    if colors is None:
        colors = sh_colors(params["shs"], params["xyz"], cam, sh_degree, ar)
    if bg is None:
        bg = torch.zeros(colors.shape[1], device=colors.device)
    bins = bin_tiles(proj, params["opacity"], cam.width, cam.height, tile, alive)
    return bins, (proj.means2d, proj.conics, params["opacity"], colors), bg


def render(params: dict, cam: Camera, ar: Arith, sh_degree: int = 3, colors=None, bg=None,
           tile: int = 16, alive=None) -> tuple[Frame, tuple]:
    """The frame, with :func:`prepare`'s inputs for :func:`blend_backward`."""
    bins, inputs, bg = prepare(params, cam, ar, sh_degree, colors, bg, tile, alive)
    frame = blend(bins, *(x.detach() for x in inputs), bg, cam.width, cam.height)
    return frame, (bins, inputs, bg)


def pixel(prepared: tuple, x: int, y: int) -> torch.Tensor:
    """One pixel's colour, blending only its tile's instances."""
    bins, inputs, bg = prepared
    gx, _, ts = bins.grid
    t = (y // ts) * gx + x // ts
    s, e = int(bins.tile_starts[t]), int(bins.tile_starts[t + 1])
    if e == s:
        return bg.clone()
    g = bins.gauss[s:e]
    with torch.no_grad():
        rgb, final_t, _, _ = _blend_chunk(bins, t, t + 1, s, e, *(v.detach()[g] for v in inputs))
    p = (y % ts) * ts + x % ts
    return rgb[0, p] + final_t[0, p] * bg
