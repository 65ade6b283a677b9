"""Scene orchestrator: cameras + the scene's Gaussians.

Counterpart of ``seganygaussians_tpu/scene.py`` with ``need_scene=True``:
resolves which PLY to load from ``(target, load_iteration)``, loads cameras
with the resolution policy and computes the NeRF++ extent.  Without a saved
iteration (training from scratch) it builds a fresh model from the point
cloud, copies the input PLY and writes ``cameras.json``, as the reference
does; :meth:`Scene.save` writes ``point_cloud/iteration_N/{target}_point_cloud.ply``.
The feature models come with a later slice and raise.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import shutil
from typing import Optional

from seganygaussians_torch.data import ply as plyio
from seganygaussians_torch.data.cameras import Camera, load_camera
from seganygaussians_torch.data.readers import detect_and_read
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
    """Host-side scene: cameras + the scene Gaussians on ``device``."""

    def __init__(
        self,
        cfg: ModelConfig,
        load_iteration: Optional[int] = None,
        shuffle: bool = True,
        resolution_scales=(1.0,),
        target: str = "scene",
        sample_rate: float = 1.0,
        seed: int = 0,
        device="cuda",
    ):
        if "feature" in target:
            raise NotImplementedError(
                "feature models: contrastive slice of the port (ROADMAP.md Queue 1)"
            )
        self.cfg = cfg
        self.model_path = cfg.model_path
        self.device = device
        self.loaded_iter: Optional[int] = None
        self.gaussians: Optional[gm.GaussianState] = None
        pc_dir = os.path.join(self.model_path, "point_cloud")

        if load_iteration is not None:
            if load_iteration == -1:
                self.loaded_iter = search_for_max_iteration(
                    pc_dir, "seg" if target == "seg" else "scene"
                )
            else:
                self.loaded_iter = load_iteration

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

        if self.loaded_iter:
            self.gaussians = self.load_scene_state(self.loaded_iter, target)
        else:
            self.gaussians = gm.create_from_points(
                info.points, info.colors, cfg.sh_degree,
                _auto_capacity(len(info.points), cfg.capacity), device=device,
            )

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
