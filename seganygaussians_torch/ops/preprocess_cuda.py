"""Preprocess on Hopper: projection, EWA covariance and SH colors as one
hand-written CUDA kernel pair, and its plain backward.

``csrc/preprocess.cu`` holds two kernels, one thread a Gaussian each, built
into one library through :class:`blend_cuda._CudaKernel` (``nvcc`` for
``sm_90a`` at first use, cached in ``build/torch_ext/`` by a digest of the
source and the flags).  The forward computes what ``ops/projection.py``'s
plain path and ``ops/sh.py:eval_sh_color`` compute, from rasterize's geometry
inputs to the tensors that enter its depth-order gathers, with no
intermediate tensor; the backward is autograd's vector-Jacobian product
through that plain path, recomputed from the inputs.
:func:`preprocess_backward_plain` repeats the backward's arithmetic in
PyTorch for the CPU tests, as ``blend_cuda.blend_backward_moments`` does for
the blend kernel.

The kernels take the SH degree (0 to 4, as a template argument, or -1 for
given colors), SH coefficients in any strides, built or given 3D
covariances, and opacities and an active mask or not.  A CUDA tensor goes
through the kernels or raises; ``ops/projection.py:preprocess`` keeps its
plain path for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from seganygaussians_torch.ops import blend_cuda
from seganygaussians_torch.ops.blend_cuda import _INT, _PTR
from seganygaussians_torch.ops.camera import CameraParams

SH_VARIANTS = (-1, 0, 1, 2, 3, 4)  # kernel instances: -1 colors given, else the SH degree
CAMERA_FLOATS = 45  # read in this order by csrc/preprocess.cu:fill_params
_FLOATS = ctypes.POINTER(ctypes.c_float)
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_HEAD = [_INT, _FLOATS, _INT, _INT, _INT, _INT, _INT, _STRIDES]


def camera_block(camera: CameraParams, tile_size: int, scale_modifier: float):
    """The camera as the kernels read it: world_view, full_proj, the centre,
    then the scalars the plain path multiplies by, each rounded to float32 as
    PyTorch rounds a Python scalar in a float32 op."""
    vals = [
        *np.asarray(camera.world_view, np.float32).reshape(-1),
        *np.asarray(camera.full_proj, np.float32).reshape(-1),
        *np.asarray(camera.cam_center, np.float32).reshape(-1),
        camera.focal_x, camera.focal_y, -camera.focal_x, -camera.focal_y,
        1.3 * camera.tan_fovx, 1.3 * camera.tan_fovy,
        camera.width, camera.height, tile_size, scale_modifier,
    ]
    return (ctypes.c_float * CAMERA_FLOATS)(*(float(v) for v in vals))


def _sh_layout(shs: Optional[torch.Tensor], sh_degree: int, n: int) -> tuple[int, int, int]:
    """(variant, C, K) of the SH coefficients (N, C, K), after the checks."""
    if shs is None:
        return -1, 0, 0
    if not 0 <= sh_degree <= 4:
        raise ValueError(f"SH degree {sh_degree} outside [0, 4]")
    if shs.dim() != 3 or shs.shape[0] != n or shs.shape[2] < (sh_degree + 1) ** 2:
        raise ValueError(f"preprocess kernel: shs shape {tuple(shs.shape)} for {n} Gaussians "
                         f"at degree {sh_degree}")
    if shs.dtype != torch.float32 or min(shs.stride()) < 0:
        raise TypeError(f"preprocess kernel: shs is {shs.dtype} with strides {shs.stride()}")
    return sh_degree, shs.shape[1], shs.shape[2]


def _strides(shs, d_shs):
    vals = [0] * 6
    if shs is not None:
        vals[:3] = shs.stride()
    if d_shs is not None:
        vals[3:] = d_shs.stride()
    return (ctypes.c_longlong * 6)(*vals)


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


class _PreprocessKernel(blend_cuda._CudaKernel):
    stem = "preprocess"
    count_keys = SH_VARIANTS

    def _inputs(self, means3d, scales, rotations, cov3d, shs, extra: dict) -> int:
        """Check the geometry inputs; returns N."""
        n = means3d.shape[0]
        tensors = {"means3d": means3d, **extra}
        if cov3d is None:
            if scales is None or rotations is None:
                raise ValueError("preprocess kernel needs scales and rotations, or cov3d")
            tensors.update(scales=scales, rotations=rotations)
        else:
            tensors["cov3d"] = cov3d
        self._check(tensors, {"active_mask": torch.bool}, means3d.device)
        widths = {"means3d": 3, "scales": 3, "rotations": 4, "cov3d": 6, "opacities": None,
                  "active_mask": None}
        for name, x in tensors.items():
            want = (n,) if widths[name] is None else (n, widths[name])
            if tuple(x.shape) != want:
                raise ValueError(f"{self.name} kernel: {name} shape {tuple(x.shape)}, needs {want}")
        if shs is not None and shs.device != means3d.device:
            raise ValueError(f"{self.name} kernel: shs on {shs.device}, means3d on {means3d.device}")
        return n


class ForwardKernel(_PreprocessKernel):
    """``csrc/preprocess.cu:preprocess_fwd_kernel``."""

    name = "preprocess_fwd"
    argtypes = _HEAD + [_PTR] * 16 + [_PTR]

    def __call__(self, means3d, camera: CameraParams, scales=None, rotations=None, cov3d=None,
                 opacities=None, active_mask=None, shs=None, sh_degree: int = 0,
                 scale_modifier: float = 1.0, tile_size: int = 16):
        """Launch the kernel; returns (means2d (N, 2), depths (N,), conics
        (N, 3), colors (N, C) or None, radii (N,) int32, rect_min (N, 2)
        int32, rect_max (N, 2) int32, tiles_touched (N,) int32, valid (N,)
        bool), as ``projection.preprocess``'s plain path and ``eval_sh_color``
        give them."""
        extra = {k: v for k, v in (("opacities", opacities), ("active_mask", active_mask))
                 if v is not None}
        n = self._inputs(means3d, scales, rotations, cov3d, shs, extra)
        variant, c, k = _sh_layout(shs, sh_degree, n)
        dev = means3d.device
        f32, i32 = dict(dtype=torch.float32, device=dev), dict(dtype=torch.int32, device=dev)
        means2d, depths, conics = (torch.empty((n, 2), **f32), torch.empty((n,), **f32),
                                   torch.empty((n, 3), **f32))
        colors = torch.empty((n, c), **f32) if shs is not None else None
        radii, tiles_touched = torch.empty((n,), **i32), torch.empty((n,), **i32)
        rect_min, rect_max = torch.empty((n, 2), **i32), torch.empty((n, 2), **i32)
        valid = torch.empty((n,), dtype=torch.bool, device=dev)
        grid_x = (camera.width + tile_size - 1) // tile_size
        grid_y = (camera.height + tile_size - 1) // tile_size
        self._launch(
            variant, n, dev, camera_block(camera, tile_size, scale_modifier), n, grid_x, grid_y,
            c, k, _strides(shs, None),
            *(_ptr(x) for x in (means3d, scales, rotations, cov3d, opacities, active_mask, shs,
                                means2d, depths, conics, colors, radii, rect_min, rect_max,
                                tiles_touched, valid)),
        )
        return means2d, depths, conics, colors, radii, rect_min, rect_max, tiles_touched, valid


class BackwardKernel(_PreprocessKernel):
    """``csrc/preprocess.cu:preprocess_bwd_kernel``."""

    name = "preprocess_bwd"
    argtypes = _HEAD + [_PTR] * 14 + [_PTR]

    def __call__(self, means3d, camera: CameraParams, scales=None, rotations=None, cov3d=None,
                 shs=None, sh_degree: int = 0, scale_modifier: float = 1.0,
                 g_means2d=None, g_depths=None, g_conics=None, g_colors=None,
                 needs=(True, True, True, True, True)):
        """Launch the kernel; returns the gradients of (means3d, scales,
        rotations, cov3d, shs), None where ``needs`` says it is not wanted or
        the input is not given.  A None upstream gradient is zero."""
        n = self._inputs(means3d, scales, rotations, cov3d, shs, {})
        variant, c, _ = _sh_layout(shs, sh_degree, n)
        given = (means3d, scales if cov3d is None else None,
                 rotations if cov3d is None else None, cov3d, shs)
        outs = [torch.empty_like(x) if x is not None and need else None
                for x, need in zip(given, needs)]
        if all(o is None for o in outs):
            return tuple(outs)
        upstream = {}
        for name, g, shape in (("g_means2d", g_means2d, (n, 2)), ("g_depths", g_depths, (n,)),
                               ("g_conics", g_conics, (n, 3)), ("g_colors", g_colors, (n, c))):
            if g is not None:
                if tuple(g.shape) != shape:
                    raise ValueError(f"{self.name} kernel: {name} shape {tuple(g.shape)}, "
                                     f"needs {shape}")
                upstream[name] = g.float().contiguous()
        self._check(upstream, {}, means3d.device)
        self._launch(
            # The backward reads no tile size or grid.
            variant, n, means3d.device, camera_block(camera, 16, scale_modifier), n, 0, 0, c,
            0 if shs is None else shs.shape[2], _strides(shs, outs[4]),
            *(_ptr(x) for x in (means3d, scales, rotations, cov3d, shs)),
            *(_ptr(upstream.get(k)) for k in ("g_means2d", "g_depths", "g_conics", "g_colors")),
            *(_ptr(o) for o in outs),
        )
        return tuple(outs)


FORWARD = ForwardKernel()
BACKWARD = BackwardKernel()


class _Preprocess(torch.autograd.Function):
    @staticmethod
    def forward(ctx, means3d, scales, rotations, cov3d, shs, opacities, active_mask, camera,
                sh_degree, scale_modifier, tile_size):
        out = FORWARD(means3d, camera, scales, rotations, cov3d, opacities, active_mask, shs,
                      sh_degree, scale_modifier, tile_size)
        ctx.mark_non_differentiable(*out[4:])
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(means3d, scales, rotations, cov3d, shs)
        ctx.static = (camera, sh_degree, scale_modifier)
        return out

    @staticmethod
    def backward(ctx, g_means2d, g_depths, g_conics, g_colors, *_):
        means3d, scales, rotations, cov3d, shs = ctx.saved_tensors
        camera, sh_degree, scale_modifier = ctx.static
        grads = BACKWARD(means3d, camera, scales, rotations, cov3d, shs, sh_degree,
                         scale_modifier, g_means2d, g_depths, g_conics, g_colors,
                         ctx.needs_input_grad[:5])
        return (*grads, None, None, None, None, None, None)


def preprocess_fused(means3d, camera: CameraParams, scales=None, rotations=None,
                     cov3d_precomp=None, scale_modifier: float = 1.0, tile_size: int = 16,
                     active_mask=None, opacities=None, shs=None, sh_degree: int = 0):
    """The forward kernel's outputs (as :meth:`ForwardKernel.__call__`),
    differentiable in means3d, scales, rotations, cov3d_precomp and shs
    through the backward kernel.  With no input requiring a gradient (or
    gradients off) the forward kernel runs alone and nothing is saved."""

    def dense(x):
        return None if x is None else x.contiguous()

    if cov3d_precomp is not None:
        scales = rotations = None
    geometry = (dense(means3d), dense(scales), dense(rotations), dense(cov3d_precomp), shs)
    rest = (None if opacities is None else opacities.detach().reshape(-1).contiguous(),
            dense(active_mask))
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad for x in geometry):
        return _Preprocess.apply(*geometry, *rest, camera, sh_degree, scale_modifier, tile_size)
    means3d, scales, rotations, cov3d, shs = geometry
    return FORWARD(means3d, camera, scales, rotations, cov3d, *rest, shs, sh_degree,
                   scale_modifier, tile_size)


def _sh_basis(deg: int, x, y, z) -> list:
    """The SH basis as ``ops/sh.py:eval_sh`` writes each term's factor."""
    from seganygaussians_torch.ops.sh import SH_C0, SH_C1, SH_C2, SH_C3, SH_C4

    b = [torch.full_like(x, SH_C0)]
    if deg > 0:
        b += [-(SH_C1 * y), SH_C1 * z, -(SH_C1 * x)]
    if deg > 1:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        b += [SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2.0 * zz - xx - yy), SH_C2[3] * xz,
              SH_C2[4] * (xx - yy)]
        if deg > 2:
            b += [SH_C3[0] * y * (3.0 * xx - yy), SH_C3[1] * xy * z,
                  SH_C3[2] * y * (4.0 * zz - xx - yy), SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                  SH_C3[4] * x * (4.0 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
                  SH_C3[6] * x * (xx - 3.0 * yy)]
            if deg > 3:
                b += [SH_C4[0] * xy * (xx - yy), SH_C4[1] * yz * (3.0 * xx - yy),
                      SH_C4[2] * xy * (7.0 * zz - 1.0), SH_C4[3] * yz * (7.0 * zz - 3.0),
                      SH_C4[4] * (zz * (35.0 * zz - 30.0) + 3.0), SH_C4[5] * xz * (7.0 * zz - 3.0),
                      SH_C4[6] * (xx - yy) * (7.0 * zz - 1.0), SH_C4[7] * xz * (xx - 3.0 * yy),
                      SH_C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy))]
    return b


def _sh_basis_vjp(deg: int, x, y, z, w: list) -> tuple:
    """d/d(x, y, z) of Σ_k w[k]·b[k] (csrc/preprocess.cu:sh_basis_vjp)."""
    from seganygaussians_torch.ops.sh import SH_C1, SH_C2, SH_C3, SH_C4

    gx = gy = gz = torch.zeros_like(x)
    if deg >= 1:
        gy = gy - SH_C1 * w[1]
        gz = gz + SH_C1 * w[2]
        gx = gx - SH_C1 * w[3]
    if deg >= 2:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        c = SH_C2
        gx = gx + c[0] * y * w[4] - 2.0 * c[2] * x * w[6] + c[3] * z * w[7] + 2.0 * c[4] * x * w[8]
        gy = gy + c[0] * x * w[4] + c[1] * z * w[5] - 2.0 * c[2] * y * w[6] - 2.0 * c[4] * y * w[8]
        gz = gz + c[1] * y * w[5] + 4.0 * c[2] * z * w[6] + c[3] * x * w[7]
    if deg >= 3:
        c = SH_C3
        gx = (gx + 6.0 * c[0] * xy * w[9] + c[1] * yz * w[10] - 2.0 * c[2] * xy * w[11]
              - 6.0 * c[3] * xz * w[12] + c[4] * (4.0 * zz - 3.0 * xx - yy) * w[13]
              + 2.0 * c[5] * xz * w[14] + 3.0 * c[6] * (xx - yy) * w[15])
        gy = (gy + 3.0 * c[0] * (xx - yy) * w[9] + c[1] * xz * w[10]
              + c[2] * (4.0 * zz - xx - 3.0 * yy) * w[11] - 6.0 * c[3] * yz * w[12]
              - 2.0 * c[4] * xy * w[13] - 2.0 * c[5] * yz * w[14] - 6.0 * c[6] * xy * w[15])
        gz = (gz + c[1] * xy * w[10] + 8.0 * c[2] * yz * w[11]
              + c[3] * (6.0 * zz - 3.0 * xx - 3.0 * yy) * w[12] + 8.0 * c[4] * xz * w[13]
              + c[5] * (xx - yy) * w[14])
    if deg >= 4:
        c = SH_C4
        xyz = xy * z
        gx = (gx + c[0] * y * (3.0 * xx - yy) * w[16] + 6.0 * c[1] * xyz * w[17]
              + c[2] * y * (7.0 * zz - 1.0) * w[18] + c[5] * z * (7.0 * zz - 3.0) * w[21]
              + 2.0 * c[6] * x * (7.0 * zz - 1.0) * w[22] + 3.0 * c[7] * z * (xx - yy) * w[23]
              + 4.0 * c[8] * x * (xx - 3.0 * yy) * w[24])
        gy = (gy + c[0] * x * (xx - 3.0 * yy) * w[16] + 3.0 * c[1] * z * (xx - yy) * w[17]
              + c[2] * x * (7.0 * zz - 1.0) * w[18] + c[3] * z * (7.0 * zz - 3.0) * w[19]
              - 2.0 * c[6] * y * (7.0 * zz - 1.0) * w[22] - 6.0 * c[7] * xyz * w[23]
              + 4.0 * c[8] * y * (yy - 3.0 * xx) * w[24])
        gz = (gz + c[1] * y * (3.0 * xx - yy) * w[17] + 14.0 * c[2] * xyz * w[18]
              + c[3] * y * (21.0 * zz - 3.0) * w[19] + c[4] * z * (140.0 * zz - 60.0) * w[20]
              + c[5] * x * (21.0 * zz - 3.0) * w[21] + 14.0 * c[6] * z * (xx - yy) * w[22]
              + c[7] * x * (xx - 3.0 * yy) * w[23])
    return gx, gy, gz


def preprocess_backward_plain(
    means3d: torch.Tensor,  # (N, 3)
    camera: CameraParams,
    scales: Optional[torch.Tensor] = None,  # (N, 3)
    rotations: Optional[torch.Tensor] = None,  # (N, 4)
    cov3d_precomp: Optional[torch.Tensor] = None,  # (N, 6)
    shs: Optional[torch.Tensor] = None,  # (N, C, K)
    sh_degree: int = 0,
    scale_modifier: float = 1.0,
    g_means2d: Optional[torch.Tensor] = None,  # (N, 2)
    g_depths: Optional[torch.Tensor] = None,  # (N,)
    g_conics: Optional[torch.Tensor] = None,  # (N, 3)
    g_colors: Optional[torch.Tensor] = None,  # (N, C)
) -> tuple:
    """The backward kernel's function in plain PyTorch, formula for formula,
    in the inputs' dtype on any device: the vector-Jacobian product of
    ``projection.preprocess``'s plain path and ``eval_sh_color`` with the
    upstream gradients of (means2d, depths, conics, colors), a None one
    being zero.  Returns the gradients of (means3d, scales, rotations,
    cov3d_precomp, shs), None for an input not given (scales and rotations
    are not used when cov3d_precomp is given)."""
    dev, dt = means3d.device, means3d.dtype
    wv, fp, cc = (t.to(dt) for t in camera.tensors(dev))
    zero = torch.zeros_like(means3d[:, 0])

    def col(g, j=None):
        if g is None:
            return zero
        return g.to(dt) if j is None else g[:, j].to(dt)

    x, y, z = means3d.unbind(-1)
    if cov3d_precomp is None:
        s = (scale_modifier * scales).unbind(-1)
        q = rotations.unbind(-1)
        nrm = torch.sqrt(((q[0] * q[0] + q[1] * q[1]) + q[2] * q[2]) + q[3] * q[3])
        r, qx, qy, qz = (v / nrm for v in q)
        R = [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - r * qz), 2 * (qx * qz + r * qy),
             2 * (qx * qy + r * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - r * qx),
             2 * (qx * qz - r * qy), 2 * (qy * qz + r * qx), 1 - 2 * (qx * qx + qy * qy)]
        L = [R[3 * a + b] * s[b] for a in range(3) for b in range(3)]

        def ldot(a, b):
            return (L[3 * a] * L[3 * b] + L[3 * a + 1] * L[3 * b + 1]) + L[3 * a + 2] * L[3 * b + 2]

        cov = [ldot(0, 0), ldot(0, 1), ldot(0, 2), ldot(1, 1), ldot(1, 2), ldot(2, 2)]
    else:
        cov = list(cov3d_precomp.unbind(-1))

    # The forward, again (csrc/preprocess.cu:geometry).
    F, V = fp.reshape(-1), wv.reshape(-1)
    ph0 = ((x * F[0] + y * F[4]) + z * F[8]) + F[12]
    ph1 = ((x * F[1] + y * F[5]) + z * F[9]) + F[13]
    ph3 = ((x * F[3] + y * F[7]) + z * F[11]) + F[15]
    pw = 1.0 / (ph3 + 1e-7)
    tx = ((x * V[0] + y * V[4]) + z * V[8]) + V[12]
    ty = ((x * V[1] + y * V[5]) + z * V[9]) + V[13]
    tz = ((x * V[2] + y * V[6]) + z * V[10]) + V[14]
    fx, fy = camera.focal_x, camera.focal_y
    limx, limy = 1.3 * camera.tan_fovx, 1.3 * camera.tan_fovy
    tzs = torch.where(tz == 0.0, torch.full_like(tz, 1e-6), tz)
    rx, ry = tx / tzs, ty / tzs
    cxr, cyr = torch.clamp(rx, -limx, limx), torch.clamp(ry, -limy, limy)
    txc, tyc = cxr * tz, cyr * tz
    inv_z = 1.0 / tzs
    inv_z2 = inv_z * inv_z
    j00, j02 = fx * inv_z, (-fx * txc) * inv_z2
    j11, j12 = fy * inv_z, (-fy * tyc) * inv_z2
    m0 = [j00 * V[4 * k] + j02 * V[4 * k + 2] for k in range(3)]
    m1 = [j11 * V[4 * k + 1] + j12 * V[4 * k + 2] for k in range(3)]
    xx, xy, xz, yy, yz, zz = cov

    def sym(m):
        return [(xx * m[0] + xy * m[1]) + xz * m[2], (xy * m[0] + yy * m[1]) + yz * m[2],
                (xz * m[0] + yz * m[1]) + zz * m[2]]

    def dot3(a, b):
        return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]

    sm0, sm1 = sym(m0), sym(m1)
    cxx, cxy, cyy = dot3(m0, sm0) + 0.3, dot3(m0, sm1), dot3(m1, sm1) + 0.3
    det = cxx * cyy - cxy * cxy
    det_valid = det != 0.0
    det_inv = 1.0 / torch.where(det_valid, det, torch.ones_like(det))

    # conic = (cyy, -cxy, cxx) / det.
    ga, gb, gc = col(g_conics, 0), col(g_conics, 1), col(g_conics, 2)
    g_di = (ga * cyy + gb * (-cxy)) + gc * cxx
    g_det = torch.where(det_valid, -g_di * (det_inv * det_inv), zero)
    g_cxx = gc * det_inv + g_det * cyy
    g_cyy = ga * det_inv + g_det * cxx
    g_cxy = -(gb * det_inv) + -2.0 * (g_det * cxy)

    # cov2d = (m0·Σm0 + .3, m0·Σm1, m1·Σm1 + .3).
    g_sm0 = [g_cxx * m0[k] for k in range(3)]
    g_sm1 = [g_cxy * m0[k] + g_cyy * m1[k] for k in range(3)]
    s0, s1 = sym(g_sm0), sym(g_sm1)
    g_m0 = [g_cxx * sm0[k] + g_cxy * sm1[k] + s0[k] for k in range(3)]
    g_m1 = [g_cyy * sm1[k] + s1[k] for k in range(3)]

    def pair(a, b):
        return (g_sm0[a] * m0[b] + g_sm0[b] * m0[a]) + (g_sm1[a] * m1[b] + g_sm1[b] * m1[a])

    g_cov = [g_sm0[0] * m0[0] + g_sm1[0] * m1[0], pair(0, 1), pair(0, 2),
             g_sm0[1] * m0[1] + g_sm1[1] * m1[1], pair(1, 2), g_sm0[2] * m0[2] + g_sm1[2] * m1[2]]

    # The Jacobian J and the clamped direction.
    g_j00 = sum(g_m0[k] * V[4 * k] for k in range(3))
    g_j02 = sum(g_m0[k] * V[4 * k + 2] for k in range(3))
    g_j11 = sum(g_m1[k] * V[4 * k + 1] for k in range(3))
    g_j12 = sum(g_m1[k] * V[4 * k + 2] for k in range(3))
    g_txc = (g_j02 * inv_z2) * -fx
    g_tyc = (g_j12 * inv_z2) * -fy
    g_inv_z2 = g_j02 * (-fx * txc) + g_j12 * (-fy * tyc)
    g_inv_z = g_j00 * fx + g_j11 * fy + 2.0 * (g_inv_z2 * inv_z)
    g_rx = torch.where((rx >= -limx) & (rx <= limx), g_txc * tz, zero)
    g_ry = torch.where((ry >= -limy) & (ry <= limy), g_tyc * tz, zero)
    g_tzs = -g_inv_z * (inv_z * inv_z) - g_rx * (rx / tzs) - g_ry * (ry / tzs)
    g_tx, g_ty = g_rx / tzs, g_ry / tzs
    g_tz = g_txc * cxr + g_tyc * cyr + col(g_depths) + torch.where(tz != 0.0, g_tzs, zero)

    # means2d = ndc2pix(p_hom[:2] / (p_hom[3] + 1e-7)).
    g_px = (col(g_means2d, 0) * 0.5) * camera.width
    g_py = (col(g_means2d, 1) * 0.5) * camera.height
    g_ph0, g_ph1 = g_px * pw, g_py * pw
    g_ph3 = -(g_px * ph0 + g_py * ph1) * (pw * pw)
    g_xyz = [((g_ph0 * F[4 * k] + g_ph1 * F[4 * k + 1]) + g_ph3 * F[4 * k + 3])
             + ((g_tx * V[4 * k] + g_ty * V[4 * k + 1]) + g_tz * V[4 * k + 2]) for k in range(3)]

    d_shs = None
    if shs is not None:
        nb = (sh_degree + 1) ** 2
        d = [x - cc[0], y - cc[1], z - cc[2]]
        norm = torch.sqrt((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2])
        nc = torch.clamp_min(norm, 1e-12)
        u = [v / nc for v in d]
        b = torch.stack(_sh_basis(sh_degree, *u), dim=-1)  # (N, nb)
        sh = shs[..., :nb].to(dt)
        pre = b[:, None, 0] * sh[..., 0]
        for k in range(1, nb):  # eval_sh's order of summation
            pre = pre + b[:, None, k] * sh[..., k]
        g_col = torch.where(pre + 0.5 >= 0.0, col(g_colors), torch.zeros_like(pre)) \
            if g_colors is not None else torch.zeros_like(pre)
        w = torch.einsum("nc,nck->nk", g_col, sh)
        d_shs = torch.zeros_like(shs, dtype=dt)
        d_shs[..., :nb] = g_col[:, :, None] * b[:, None, :]
        gu = _sh_basis_vjp(sh_degree, *u, list(w.unbind(-1)))
        g_nc = -sum((gu[k] * (d[k] / nc)) / nc for k in range(3))
        g_norm = torch.where(norm >= 1e-12, g_nc, zero)
        scale = torch.where(norm == 0.0, zero, g_norm / torch.where(norm == 0.0, 1.0, norm))
        g_xyz = [g_xyz[k] + gu[k] / nc + d[k] * scale for k in range(3)]
    d_means3d = torch.stack(g_xyz, dim=-1)

    if cov3d_precomp is not None:
        return d_means3d, None, None, torch.stack(g_cov, dim=-1), d_shs

    # cov = strip(L Lᵀ), L = R·diag(s): dL = (G + Gᵀ)·L, G upper triangular.
    G = [2 * g_cov[0], g_cov[1], g_cov[2], g_cov[1], 2 * g_cov[3], g_cov[4],
         g_cov[2], g_cov[4], 2 * g_cov[5]]
    gL = [(G[3 * a] * L[k] + G[3 * a + 1] * L[3 + k]) + G[3 * a + 2] * L[6 + k]
          for a in range(3) for k in range(3)]
    gR = [gL[3 * a + k] * s[k] for a in range(3) for k in range(3)]
    gs = [sum(gL[3 * a + k] * R[3 * a + k] for a in range(3)) for k in range(3)]
    d_scales = torch.stack(gs, dim=-1) * scale_modifier
    gq = [
        2 * ((-qz * gR[1] + qy * gR[2]) + (qz * gR[3] - qx * gR[5]) + (-qy * gR[6] + qx * gR[7])),
        2 * ((qy * gR[1] + qz * gR[2]) + (qy * gR[3] - 2 * qx * gR[4])
             + ((-r * gR[5] + qz * gR[6]) + r * gR[7]) - 2 * qx * gR[8]),
        2 * ((-2 * qy * gR[0] + qx * gR[1]) + (r * gR[2] + qx * gR[3])
             + ((qz * gR[5] - r * gR[6]) + qz * gR[7]) - 2 * qy * gR[8]),
        2 * ((-2 * qz * gR[0] - r * gR[1]) + (qx * gR[2] + r * gR[3])
             + ((-2 * qz * gR[4] + qy * gR[5]) + qx * gR[6]) + qy * gR[7]),
    ]
    # qn = q / √Σq².
    g_nrm = sum(-gq[j] * ((q[j] / nrm) / nrm) for j in range(4))
    g_ss = g_nrm / (2 * nrm)
    d_rotations = torch.stack([gq[j] / nrm + 2 * (g_ss * q[j]) for j in range(4)], dim=-1)
    return d_means3d, d_scales, d_rotations, None, d_shs
