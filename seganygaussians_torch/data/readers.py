"""Scene readers: COLMAP, Blender (NeRF-synthetic) and LERF.

Counterpart of ``seganygaussians_tpu/data/readers.py``.  Returns
``SceneInfo`` with raw ``CameraInfo`` records; pixels are loaded later by
``load_camera``.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple, Optional

import numpy as np

from seganygaussians_torch.data import colmap
from seganygaussians_torch.data.cameras import CameraInfo
from seganygaussians_torch.data.ply import load_point_cloud_ply, save_point_cloud_ply
from seganygaussians_torch.ops.camera import focal2fov, fov2focal, get_world2view
from seganygaussians_torch.ops.sh import SH_C0


class SceneInfo(NamedTuple):
    points: Optional[np.ndarray]  # (N, 3)
    colors: Optional[np.ndarray]  # (N, 3) in [0,1]
    train_cameras: list[CameraInfo]
    test_cameras: list[CameraInfo]
    translate: np.ndarray  # NeRF++ normalisation
    radius: float
    ply_path: str


def get_nerfpp_norm(cam_infos: list[CameraInfo]) -> tuple[np.ndarray, float]:
    """Camera-centroid radius normalisation."""
    centers = []
    for cam in cam_infos:
        w2c = get_world2view(cam.R, cam.T)
        centers.append(np.linalg.inv(w2c)[:3, 3])
    centers = np.stack(centers, axis=0)
    center = centers.mean(axis=0)
    diagonal = np.max(np.linalg.norm(centers - center, axis=-1))
    return -center, float(diagonal * 1.1)


def _sidecar(path: str, folder: str, image_name: str, enabled: bool):
    if not enabled:
        return None
    p = os.path.join(path, folder, image_name + ".pt")
    return p if os.path.exists(p) else None


def read_colmap_scene(
    path: str,
    images: Optional[str] = None,
    eval_split: bool = False,
    llffhold: int = 8,
    need_features: bool = False,
    need_masks: bool = False,
    sample_rate: float = 1.0,
    allow_principal_point_shift: bool = False,
    replica: bool = False,
) -> SceneInfo:
    """COLMAP scene: bin/text fallback, ``sample_rate`` keeps the first
    sample_rate·10 of every 10 cameras, the eval split takes every
    ``llffhold``-th view, points3D → cached PLY."""
    sparse = os.path.join(path, "sparse/0")
    cams, images_meta, pts = colmap.read_model(sparse)

    reading_dir = images if images else "images"
    infos = []
    for idx, key in enumerate(images_meta):
        if idx % 10 >= sample_rate * 10:
            continue
        extr = images_meta[key]
        intr = cams[extr.camera_id]
        if not (np.isfinite(extr.qvec).all() and np.isfinite(extr.tvec).all()):
            print(f"[readers] skipping {extr.name}: non-finite pose")
            continue
        R = colmap.qvec2rotmat(extr.qvec).T
        T = np.array(extr.tvec)
        if intr.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
            fovy = focal2fov(intr.params[0], intr.height)
            fovx = focal2fov(intr.params[0], intr.width)
        elif intr.model == "PINHOLE":
            fovy = focal2fov(intr.params[1], intr.height)
            fovx = focal2fov(intr.params[0], intr.width)
        else:
            raise ValueError(f"unsupported COLMAP camera model {intr.model}")
        image_name = os.path.basename(extr.name).split(".")[0]
        shift_ok = len(intr.params) > 3 and allow_principal_point_shift
        infos.append(
            CameraInfo(
                uid=intr.id,
                R=R,
                T=T,
                fovx=fovx,
                fovy=fovy,
                image_path=os.path.join(path, reading_dir, os.path.basename(extr.name)),
                image_name=image_name,
                width=intr.width,
                height=intr.height,
                cx=intr.params[2] if shift_ok else None,
                cy=intr.params[3] if shift_ok else None,
                features_path=_sidecar(path, "clip_features", image_name, need_features),
                masks_path=_sidecar(path, "sam_masks", image_name, need_masks),
                mask_scales_path=_sidecar(path, "mask_scales", image_name, need_masks),
            )
        )

    if replica:
        infos.sort(key=lambda c: int(c.image_name.split("_")[-1]))
    else:
        infos.sort(key=lambda c: c.image_name)

    if eval_split:
        train = [c for i, c in enumerate(infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(infos) if i % llffhold == 0]
    else:
        train, test = infos, []

    translate, radius = get_nerfpp_norm(train)

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path) and pts is not None:
        xyz, rgb, _ = pts
        save_point_cloud_ply(ply_path, xyz.astype(np.float32), rgb / 255.0)
    points = colors = None
    if os.path.exists(ply_path):
        points, colors = load_point_cloud_ply(ply_path)

    return SceneInfo(points, colors, train, test, translate, radius, ply_path)


def _c2w_to_rt(transform_matrix) -> tuple[np.ndarray, np.ndarray]:
    """A NeRF/Blender camera-to-world matrix → COLMAP's (R, T): flip the
    camera's y and z axes (OpenGL → COLMAP), invert, keep R transposed."""
    c2w = np.array(transform_matrix)
    c2w[:3, 1:3] *= -1
    w2c = np.linalg.inv(c2w)
    return np.transpose(w2c[:3, :3]), w2c[:3, 3]


def _read_transforms(path: str, transformsfile: str, extension: str = ".png") -> list[CameraInfo]:
    """A Blender ``transforms_*.json`` → CameraInfos (one shared
    ``camera_angle_x``; the image size read from each image file)."""
    from PIL import Image

    infos = []
    with open(os.path.join(path, transformsfile)) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    for idx, frame in enumerate(contents["frames"]):
        file_path = frame["file_path"]
        if not os.path.splitext(file_path)[1]:
            file_path = file_path + extension
        image_path = os.path.join(path, file_path)
        R, T = _c2w_to_rt(frame["transform_matrix"])
        with Image.open(image_path) as im:
            w, h = im.size
        infos.append(
            CameraInfo(
                uid=idx,
                R=R,
                T=T,
                fovx=fovx,
                fovy=focal2fov(fov2focal(fovx, w), h),
                image_path=image_path,
                image_name=os.path.basename(image_path).split(".")[0],
                width=w,
                height=h,
            )
        )
    return infos


def read_blender_scene(
    path: str,
    white_background: bool = False,
    eval_split: bool = False,
    extension: str = ".png",
) -> SceneInfo:
    """NeRF-synthetic scene: the transforms JSONs' cameras (the test split
    joins the training views unless ``eval_split``), and 100k seeded random
    points in [-1.3, 1.3)³ written to ``points3d.ply`` when there is none."""
    del white_background  # applied when the images are loaded
    train = _read_transforms(path, "transforms_train.json", extension)
    test = (
        _read_transforms(path, "transforms_test.json", extension)
        if os.path.exists(os.path.join(path, "transforms_test.json"))
        else []
    )
    if not eval_split:
        train, test = train + test, []

    translate, radius = get_nerfpp_norm(train)

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        num_pts = 100_000
        rng = np.random.default_rng(0)
        xyz = rng.random((num_pts, 3)) * 2.6 - 1.3
        shs = rng.random((num_pts, 3)) / 255.0
        save_point_cloud_ply(ply_path, xyz.astype(np.float32), shs * SH_C0 + 0.5)
    points, colors = load_point_cloud_ply(ply_path)

    return SceneInfo(points, colors, train, test, translate, radius, ply_path)


def read_lerf_scene(path: str, extension: str = ".png") -> SceneInfo:
    """LERF scene: one ``transforms.json`` with intrinsics per frame or
    shared (``fl_x``, ``fl_y``, ``cx``, ``cy``, ``w``, ``h``); no eval split;
    the point cloud only if ``points3d.ply`` exists.  (``extension`` is
    accepted and unused, as in the JAX reader.)"""
    del extension
    infos = []
    with open(os.path.join(path, "transforms.json")) as f:
        contents = json.load(f)
    for idx, frame in enumerate(contents["frames"]):
        image_path = os.path.join(path, frame["file_path"])
        R, T = _c2w_to_rt(frame["transform_matrix"])
        w = int(frame.get("w", contents.get("w")))
        h = int(frame.get("h", contents.get("h")))
        fl_x = float(frame.get("fl_x", contents.get("fl_x")))
        fl_y = float(frame.get("fl_y", contents.get("fl_y", fl_x)))
        infos.append(
            CameraInfo(
                uid=idx,
                R=R,
                T=T,
                fovx=focal2fov(fl_x, w),
                fovy=focal2fov(fl_y, h),
                image_path=image_path,
                image_name=os.path.basename(image_path).split(".")[0],
                width=w,
                height=h,
                cx=float(frame.get("cx", contents.get("cx", w / 2))),
                cy=float(frame.get("cy", contents.get("cy", h / 2))),
            )
        )
    translate, radius = get_nerfpp_norm(infos)
    ply_path = os.path.join(path, "points3d.ply")
    points = colors = None
    if os.path.exists(ply_path):
        points, colors = load_point_cloud_ply(ply_path)
    return SceneInfo(points, colors, infos, [], translate, radius, ply_path)


def detect_and_read(path: str, **kwargs) -> SceneInfo:
    """COLMAP vs Blender vs LERF auto-detect."""
    if os.path.exists(os.path.join(path, "sparse")):
        allowed = (
            "images", "eval_split", "llffhold", "need_features", "need_masks",
            "sample_rate", "allow_principal_point_shift", "replica",
        )
        return read_colmap_scene(path, **{k: v for k, v in kwargs.items() if k in allowed})
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        allowed = ("white_background", "eval_split", "extension")
        return read_blender_scene(path, **{k: v for k, v in kwargs.items() if k in allowed})
    if os.path.exists(os.path.join(path, "transforms.json")):
        return read_lerf_scene(path)
    raise ValueError(f"could not recognise scene type at {path}")
