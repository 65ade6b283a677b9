"""Camera math: world→view, perspective projection, FoV helpers.

Counterpart of ``seganygaussians_tpu/ops/camera.py``.  Matrices are stored so
that a ROW vector multiplies on the LEFT (``p_clip = [x y z 1] @ full_proj``),
and the view matrix supports the optional principal-point shift used by
LERF/3DOVS data.  ``CameraParams`` is host-side (numpy and Python floats);
:meth:`CameraParams.tensors` makes the device tensors the rasterizer reads.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from seganygaussians_torch.utils import tracing


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def get_world2view(
    R: np.ndarray,
    t: np.ndarray,
    translate: np.ndarray | None = None,
    scale: float = 1.0,
) -> np.ndarray:
    """World→view 4×4 (column-vector convention).

    ``R`` is the camera-to-world rotation as COLMAP readers store it and ``t``
    the world-to-camera translation; ``translate``/``scale`` recentre the
    scene (NeRF++ normalisation).
    """
    if translate is None:
        translate = np.zeros(3)
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    c2w = np.linalg.inv(Rt)
    cam_center = (c2w[:3, 3] + translate) * scale
    c2w[:3, 3] = cam_center
    return np.linalg.inv(c2w).astype(np.float32)


def get_projection_matrix(
    znear: float,
    zfar: float,
    fovx: float,
    fovy: float,
    w: Optional[float] = None,
    h: Optional[float] = None,
    cx: Optional[float] = None,
    cy: Optional[float] = None,
    allow_principal_point_shift: bool = True,
) -> np.ndarray:
    """Perspective projection (column-vector convention) with the optional
    principal-point window shift."""
    tan_half_fovy = math.tan(fovy / 2.0)
    tan_half_fovx = math.tan(fovx / 2.0)

    top = tan_half_fovy * znear
    bottom = -top
    right = tan_half_fovx * znear
    left = -right

    if None not in (w, h, cx, cy) and allow_principal_point_shift:
        focal_x = w / (2.0 * math.tan(fovx / 2.0))
        focal_y = h / (2.0 * math.tan(fovy / 2.0))
        offset_x = (cx - w / 2.0) / focal_x * znear
        offset_y = (cy - h / 2.0) / focal_y * znear
        top += offset_y
        bottom += offset_y
        left += offset_x
        right += offset_x

    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


@dataclasses.dataclass(frozen=True)
class CameraParams:
    """Host-side camera bundle consumed by the rasterizer.

    ``world_view`` and ``full_proj`` follow the row-vector convention:
    ``p_view = p_hom @ world_view`` and ``p_clip = p_hom @ full_proj``.
    """

    world_view: np.ndarray  # (4, 4) float32
    full_proj: np.ndarray  # (4, 4) float32
    cam_center: np.ndarray  # (3,) float32
    width: int
    height: int
    tan_fovx: float
    tan_fovy: float

    @property
    def focal_x(self) -> float:
        return self.width / (2.0 * self.tan_fovx)

    @property
    def focal_y(self) -> float:
        return self.height / (2.0 * self.tan_fovy)

    def tensors(self, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(world_view, full_proj, cam_center) as float32 tensors on ``device``
        (each copy from pageable host memory waits for the device)."""
        with tracing.sync("camera", 3):
            return tuple(
                torch.tensor(np.asarray(a, np.float32), device=device)
                for a in (self.world_view, self.full_proj, self.cam_center)
            )


def make_camera(
    R: np.ndarray,
    t: np.ndarray,
    fovx: float,
    fovy: float,
    width: int,
    height: int,
    znear: float = 0.01,
    zfar: float = 100.0,
    translate: np.ndarray | None = None,
    scale: float = 1.0,
    cx: Optional[float] = None,
    cy: Optional[float] = None,
    allow_principal_point_shift: bool = False,
) -> CameraParams:
    """Build a CameraParams from COLMAP-style extrinsics."""
    w2v = get_world2view(R, t, translate, scale)  # column-vector 4x4
    world_view = w2v.T  # row-vector convention
    if allow_principal_point_shift and cx is not None and cy is not None:
        proj = get_projection_matrix(
            znear, zfar, fovx, fovy, width, height, cx, cy, True
        )
    else:
        proj = get_projection_matrix(znear, zfar, fovx, fovy)
    full_proj = world_view @ proj.T
    cam_center = np.linalg.inv(w2v)[:3, 3]
    return CameraParams(
        world_view=np.asarray(world_view, np.float32),
        full_proj=np.asarray(full_proj, np.float32),
        cam_center=np.asarray(cam_center, np.float32),
        width=int(width),
        height=int(height),
        tan_fovx=float(math.tan(fovx / 2.0)),
        tan_fovy=float(math.tan(fovy / 2.0)),
    )
