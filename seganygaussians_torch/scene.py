"""Scene orchestrator: cameras + the scene's and the feature Gaussians.

Counterpart of ``seganygaussians_tpu/scene.py``: resolves which PLYs to load
from ``(target, mode, load_iteration)``, loads cameras with the resolution
policy and computes the NeRF++ extent.  Without a saved iteration (training
from scratch) it builds a fresh model from the point cloud, copies the input
PLY and writes ``cameras.json``, as the reference does; :meth:`Scene.save`
writes ``point_cloud/iteration_N/{target}_point_cloud.ply`` and
:meth:`Scene.save_feature` the feature PLY.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import shutil
from typing import Optional

import numpy as np
import torch

from seganygaussians_torch.data import ply as plyio
from seganygaussians_torch.data.cameras import Camera, load_camera
from seganygaussians_torch.data.readers import detect_and_read
from seganygaussians_torch.models import feature_gaussians as fgm
from seganygaussians_torch.models import gaussians as gm


@dataclasses.dataclass
class ModelConfig:
    """The ModelParams flag group."""

    source_path: str = ""
    model_path: str = ""
    feature_model_path: str = ""
    images: str = "images"
    resolution: int = -1
    sh_degree: int = 3
    feature_dim: int = 32
    white_background: bool = False
    eval: bool = False
    need_features: bool = False
    need_masks: bool = False
    allow_principle_point_shift: bool = False
    init_from_3dgs_pcd: bool = False
    capacity: int = 0  # 0 ⇒ auto (next power of two ≥ 4·n)


def search_for_max_iteration(folder: str, target: str = "scene") -> Optional[int]:
    """Latest iteration dir containing a ``*{target}*`` PLY."""
    if not os.path.isdir(folder):
        return None
    iters = []
    for fname in os.listdir(folder):
        cur = os.path.join(folder, fname)
        if not os.path.isdir(cur):
            continue
        if any(target in p for p in os.listdir(cur)):
            iters.append(int(fname.split("_")[-1]))
    return max(iters) if iters else None


def _auto_capacity(n: int, requested: int) -> int:
    if requested:
        return max(requested, n)
    cap = 1 << 12
    while cap < 4 * n:
        cap *= 2
    return cap


class Scene:
    """Host-side scene: cameras + (optionally) the scene and feature
    Gaussians on ``device``.

    ``target`` ∈ {scene, seg, feature, coarse_seg_everything,
    contrastive_feature}, ``mode`` ∈ {train, eval}, the JAX package's matrix.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        need_scene: bool = True,
        need_features_model: bool = False,
        load_iteration: Optional[int] = None,
        feature_load_iteration: Optional[int] = None,
        shuffle: bool = True,
        resolution_scales=(1.0,),
        target: str = "scene",
        mode: str = "train",
        sample_rate: float = 1.0,
        seed: int = 0,
        device="cuda",
    ):
        self.cfg = cfg
        self.model_path = cfg.model_path
        self.device = device
        self.loaded_iter: Optional[int] = None
        self.feature_loaded_iter: Optional[int] = None
        self.gaussians: Optional[gm.GaussianState] = None
        self.feature_gaussians: Optional[fgm.FeatureState] = None
        pc_dir = os.path.join(self.model_path, "point_cloud")

        if load_iteration is not None:
            if load_iteration == -1:
                self.loaded_iter = search_for_max_iteration(
                    pc_dir, "seg" if (mode == "eval" and target == "seg") else "scene"
                )
            else:
                self.loaded_iter = load_iteration
            if target in ("seg", "coarse_seg_everything") and mode == "train":
                self.feature_loaded_iter = (
                    search_for_max_iteration(pc_dir, "feature")
                    if feature_load_iteration in (None, -1)
                    else feature_load_iteration
                )
            elif mode == "eval" and target in (
                "feature", "contrastive_feature", "coarse_seg_everything"
            ):
                self.feature_loaded_iter = (
                    search_for_max_iteration(pc_dir, target)
                    if feature_load_iteration in (None, -1)
                    else feature_load_iteration
                )

        info = detect_and_read(
            cfg.source_path,
            images=cfg.images,
            eval_split=cfg.eval,
            need_features=cfg.need_features,
            need_masks=cfg.need_masks,
            sample_rate=sample_rate,
            allow_principal_point_shift=cfg.allow_principle_point_shift,
            replica="replica" in cfg.model_path,
            white_background=cfg.white_background,
        )
        self.cameras_extent = info.radius

        if not self.loaded_iter and self.model_path:
            os.makedirs(self.model_path, exist_ok=True)
            if os.path.exists(info.ply_path):
                shutil.copyfile(info.ply_path, os.path.join(self.model_path, "input.ply"))
            cams_json = [
                {"id": i, "img_name": c.image_name, "width": c.width, "height": c.height,
                 "fovx": c.fovx, "fovy": c.fovy}
                for i, c in enumerate(info.train_cameras + info.test_cameras)
            ]
            with open(os.path.join(self.model_path, "cameras.json"), "w") as f:
                json.dump(cams_json, f)

        train_infos = list(info.train_cameras)
        test_infos = list(info.test_cameras)
        if shuffle:
            rng = random.Random(seed)
            rng.shuffle(train_infos)
            rng.shuffle(test_infos)

        def load_all(infos, scale):
            return [
                load_camera(
                    ci, uid=i, resolution=cfg.resolution, resolution_scale=scale,
                    white_background=cfg.white_background,
                    allow_principal_point_shift=cfg.allow_principle_point_shift,
                )
                for i, ci in enumerate(infos)
            ]

        self.train_cameras: dict[float, list[Camera]] = {}
        self.test_cameras: dict[float, list[Camera]] = {}
        for scale in resolution_scales:
            self.train_cameras[scale] = load_all(train_infos, scale)
            self.test_cameras[scale] = load_all(test_infos, scale)

        if need_scene:
            if self.loaded_iter:
                name = "scene" if ("feature" in target or target == "coarse_seg_everything"
                                   or mode == "train") else target
                self.gaussians = self.load_scene_state(self.loaded_iter, name)
            else:
                self.gaussians = gm.create_from_points(
                    info.points, info.colors, cfg.sh_degree,
                    _auto_capacity(len(info.points), cfg.capacity), device=device,
                )
        if need_features_model:
            self.feature_gaussians = self._load_feature_state(info, pc_dir, target, mode, seed)

    def _load_feature_state(self, info, pc_dir, target, mode, seed) -> Optional[fgm.FeatureState]:
        cfg = self.cfg

        def scene_ply():
            scene_iter = self.loaded_iter or search_for_max_iteration(pc_dir, "scene")
            return os.path.join(pc_dir, f"iteration_{scene_iter}", "scene_point_cloud.ply")

        if target == "feature" and not self.feature_loaded_iter:
            # A fresh feature model, seeded either from the trained scene
            # PLY's xyz (init_from_3dgs_pcd) or from the Colmap point cloud.
            pts = (plyio.load_gaussians_ply(scene_ply())["xyz"] if cfg.init_from_3dgs_pcd
                   else info.points)
            return fgm.from_point_cloud(
                np.asarray(pts), feature_dim=cfg.feature_dim,
                capacity=_auto_capacity(len(pts), cfg.capacity), device=self.device,
            )
        if target in ("contrastive_feature", "coarse_seg_everything") and mode == "train":
            d = plyio.load_gaussians_ply(scene_ply())
            return fgm.from_scene_geometry(
                d["xyz"], d["scaling"], d["rotation"], d["opacity"],
                feature_dim=cfg.feature_dim, target=target, seed=seed, device=self.device,
            )
        if self.feature_loaded_iter:
            src = os.path.join(
                pc_dir, f"iteration_{self.feature_loaded_iter}",
                f"{'feature' if target == 'seg' else target}_point_cloud.ply",
            )
            d = plyio.load_feature_gaussians_ply(src)

            def t(a):
                return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

            xyz = t(d["xyz"])
            return fgm.FeatureState(
                geom=fgm.FrozenGeometry(
                    xyz=xyz, scaling=t(d["scaling"]), rotation=t(d["rotation"]),
                    opacity=t(d["opacity"]),
                    alive=torch.ones(xyz.shape[0], dtype=torch.bool, device=self.device),
                ),
                point_features=t(d["features"]),
                smooth_map=fgm.build_smooth_map(xyz, 16),
                opt=None,  # eval-mode load
            )
        return None

    def _iter_dir(self, iteration: int) -> str:
        return os.path.join(self.model_path, "point_cloud", f"iteration_{iteration}")

    def save(self, iteration: int, target: str = "scene") -> str:
        """Write the live Gaussians as a 3DGS PLY; returns its path."""
        d = gm.compact(self.gaussians)
        path = os.path.join(self._iter_dir(iteration), f"{target}_point_cloud.ply")
        plyio.save_gaussians_ply(
            path, d["xyz"], d["features_dc"], d["features_rest"],
            d["opacity"], d["scaling"], d["rotation"],
        )
        return path

    def save_mask(self, iteration: int, mask: np.ndarray, idx: int = 0) -> str:
        path = os.path.join(self._iter_dir(iteration), f"seg_point_cloud_{idx}.npy")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, mask)
        return path

    def save_feature(
        self, iteration: int, target: str = "contrastive_feature",
        smooth_type: Optional[str] = "traditional",
        multi_res_maps: Optional[tuple] = None, seed: int = 0,
    ) -> str:
        """Save the feature PLY — with SMOOTHED features when ``smooth_type``
        is 'traditional' (all K neighbours, no dropout) or 'multi_res'.

        For 'multi_res', pass the trainer's cached ``multi_res_maps`` (or at
        least its ``seed``), so that the export smooths over the per-level
        subsamples the features were optimised against."""
        fs = self.feature_gaussians
        with torch.no_grad():
            if smooth_type == "traditional":
                feats = fgm.smoothed_point_features(fs)
            elif smooth_type == "multi_res":
                device = fs.point_features.device
                maps = multi_res_maps or fgm.build_multi_res_maps(
                    fs, torch.Generator(device=device).manual_seed(seed)
                )
                feats = fgm.multi_res_smoothed_features(fs, maps)
            else:
                feats = fs.point_features
        alive = fs.geom.alive.cpu().numpy()

        def live(x):
            return x.detach().cpu().numpy()[alive]

        path = os.path.join(self._iter_dir(iteration), f"{target}_point_cloud.ply")
        plyio.save_feature_gaussians_ply(
            path, live(fs.geom.xyz), live(feats), live(fs.geom.opacity),
            live(fs.geom.scaling), live(fs.geom.rotation),
        )
        return path

    def load_scene_state(self, iteration: int, target: str = "scene") -> gm.GaussianState:
        path = os.path.join(self._iter_dir(iteration), f"{target}_point_cloud.ply")
        d = plyio.load_gaussians_ply(path)
        cap = _auto_capacity(len(d["xyz"]), self.cfg.capacity)
        return gm.from_dense(
            d["xyz"], d["features_dc"], d["features_rest"], d["scaling"],
            d["rotation"], d["opacity"], capacity=cap, device=self.device,
        )

    def get_train_cameras(self, scale: float = 1.0) -> list[Camera]:
        return self.train_cameras[scale]

    def get_test_cameras(self, scale: float = 1.0) -> list[Camera]:
        return self.test_cameras[scale]
