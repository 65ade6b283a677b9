"""Seeded scenes for the preprocess kernel pair and its plain counterparts.

Shared by the CPU tests (``test_torch_preprocess.py``) and the card tests
(``test_torch_cuda.py``); imports nothing of JAX.  Each scene holds the edge
cases of the plain path's gradient: Gaussians behind the near plane and at
view-space z = 0, dead slots, directions past the 1.3·tan(fov) clamp, colors
clamped at 0.  Cases: ``rotated`` (a rotated camera), ``axis`` (the camera at
the origin: view-space z exactly 0, one Gaussian at the camera centre),
``cov3d`` (given 3D covariances), ``det0`` (a 2D covariance whose determinant
is 0), ``sliced`` (the SH a view of the first (deg + 1)² coefficients, so a
Gaussian's values are not dense).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from seganygaussians_torch.ops.camera import CameraParams, get_projection_matrix, make_camera



def _rotation(rng) -> np.ndarray:
    q = rng.normal(size=4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _det0_camera(width: int = 64, height: int = 48) -> CameraParams:
    """An identity camera with tan(fovx/2) = 0.5 exactly, so that the focal
    length (64) and the Jacobian at z = 4 (16) are powers of two."""
    tan_x, tan_y = 0.5, 0.5 * height / width
    proj = get_projection_matrix(0.01, 100.0, 2 * math.atan(tan_x), 2 * math.atan(tan_y))
    wv = np.eye(4, dtype=np.float32)
    return CameraParams(world_view=wv, full_proj=np.asarray(wv @ proj.T, np.float32),
                        cam_center=np.zeros(3, np.float32), width=width, height=height,
                        tan_fovx=tan_x, tan_fovy=tan_y)


def scene(seed: int, case: str = "rotated", sh_degree: int = 3, n: int = 300,
          channels: int = 3, dtype=torch.float64):
    """(camera, inputs, live): inputs for ``preprocess`` with ``shs`` (N, C,
    K) at ``sh_degree``, K = 16 (25 at degree 4): coefficients past the
    degree are there, as in a model warming up its degree.  ``live`` marks
    the rows a blend could reach (in front, active)."""
    rng = np.random.default_rng(seed)
    width, height = 96, 64
    if case == "det0":
        camera = _det0_camera()
        rot = np.eye(3)
        centre = np.zeros(3)
    else:
        # "axis": the camera at the origin, looking down +z, so view-space z
        # is exactly the world z.
        rot = np.eye(3) if case == "axis" else _rotation(rng)
        centre = np.zeros(3) if case == "axis" else rng.normal(size=3)
        t = -rot.T @ centre
        camera = make_camera(rot, t, fovx=1.1, fovy=0.8, width=width, height=height)
    tan_x, tan_y = camera.tan_fovx, camera.tan_fovy
    z = rng.uniform(0.5, 8.0, n)
    z[: n // 10] = rng.uniform(-3.0, 0.19, n // 10)  # behind the near plane
    fx = rng.uniform(-1.1, 1.1, n)
    fy = rng.uniform(-1.1, 1.1, n)
    past = slice(n // 10, n // 5)  # directions past the clamp, on both sides
    fx[past] = rng.choice([-1, 1], n // 10) * rng.uniform(1.4, 3.0, n // 10)
    fy[past] = rng.choice([-1, 1], n // 10) * rng.uniform(1.4, 3.0, n // 10)
    cam_pts = np.stack([fx * tan_x * np.abs(z), fy * tan_y * np.abs(z), z], 1)
    if case == "axis":
        cam_pts[0] = (0.0, 0.0, 0.0)  # view-space z exactly 0, at the camera centre
        cam_pts[1] = (0.3, -0.2, 0.0)
    if case == "det0":
        cam_pts[0] = (0.0, 0.0, 4.0)
    means = (rot @ cam_pts.T).T + centre
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    scales = np.exp(rng.uniform(-4.0, -1.0, (n, 3)))
    opac = rng.uniform(0.002, 0.99, n)
    shs = rng.normal(scale=0.3, size=(n, max(16, (sh_degree + 1) ** 2), channels))
    shs[n // 5: n // 4, 0, :] = -4.0  # colors clamped at 0
    active = rng.uniform(size=n) > 0.1
    active[0] = True
    inputs = dict(
        means3d=torch.tensor(means, dtype=dtype),
        scales=torch.tensor(scales, dtype=dtype),
        rotations=torch.tensor(quats, dtype=dtype),
        opacities=torch.tensor(opac, dtype=dtype),
        active_mask=torch.tensor(active),
        # (N, C, 16) channels first, a transposed view as models/gaussians.get_shs gives it
        shs=torch.tensor(shs, dtype=dtype).transpose(1, 2),
        sh_degree=sh_degree,
    )
    if case == "sliced":
        inputs["shs"] = inputs["shs"][..., : (sh_degree + 1) ** 2]
    if case in ("cov3d", "det0"):
        a = rng.normal(scale=0.08, size=(n, 3, 3))
        cov = a @ a.transpose(0, 2, 1) + 1e-4 * np.eye(3)
        packed = cov[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]
        if case == "det0":
            # Σ_xx = −0.3 / 16²: J Σ Jᵀ + 0.3 has c_xx = 0 and c_xy = 0 exactly.
            packed[0] = (-0.3 / 256.0, 0.0, 0.0, 0.1, 0.0, 0.1)
        inputs["cov3d_precomp"] = torch.tensor(packed, dtype=dtype)
        del inputs["scales"], inputs["rotations"]
    live = torch.tensor((cam_pts[:, 2] > 0.2) & active)
    return camera, inputs, live


def cotangents(seed: int, n: int, channels: int, live: torch.Tensor, dtype=torch.float64):
    """Seeded upstream gradients of (means2d, depths, conics, colors), zero
    on the rows no blend reaches, as the blend's backward leaves them."""
    rng = np.random.default_rng(seed + 1000)
    out = []
    for width in (2, None, 3, channels):
        shape = (n,) if width is None else (n, width)
        g = torch.tensor(rng.normal(size=shape), dtype=dtype)
        mask = live if width is None else live[:, None]
        out.append(torch.where(mask, g, torch.zeros_like(g)))
    return tuple(out)
