"""Interactive 3D segmentation session (the reference's ``saga_gui.py``).

Counterpart of ``seganygaussians_tpu/viewer/interactive.py``.  The session
logic (orbit camera, per-frame RGB and feature renders, PCA preview,
scale-gated click similarity, 3D clustering overlay, ``segment3d``, mask
save and undo) lives in a headless :class:`SagaSession`, so that any front
end (``viewer/web_gui.py``, a notebook) can drive it:

* render modes RGB / PCA / similarity / cluster
* the scale slider → a quantile-space gate value (``scale``)
* a left click → the clicked pixel's gated feature, a prompt
* segment3d: per-Gaussian gated similarity > ``threshold``
* cluster_in_3d: subsample → spherical k-means → cluster centers
* save_mask → ``./segmentation_res/<name>.pt``; roll_back / clear_clicks

On CUDA tensors every render goes through the forward blend kernel (C = 3
for RGB, C = feature_dim for the feature map); on CPU tensors through the
plain blend.  The JAX session's ``jax.random`` key becomes one
``torch.Generator`` on the session's device; where a draw cannot be
repeated across the two packages (the PCA subsample, the clustering's
subsample and initial centers, the cluster palette), the methods also take
the draw as an argument.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from seganygaussians_torch.data.cameras import orbit_camera_params
from seganygaussians_torch.models import feature_gaussians as fgm
from seganygaussians_torch.models import gaussians as gm
from seganygaussians_torch.ops.camera import CameraParams
from seganygaussians_torch.ops.rasterize import RasterConfig, rasterize
from seganygaussians_torch.seg import clustering, queries
from seganygaussians_torch.seg.scale_gate import ScaleGateParams
from seganygaussians_torch.utils.precision import ieee_fp32_matmul


@torch.no_grad()
def render_view(
    state: gm.GaussianState,
    camera: CameraParams,
    sh_degree: int = 3,
    config: Optional[RasterConfig] = None,
) -> np.ndarray:
    """One RGB frame for any camera, clamped to [0, 1], as a host (H, W, 3)
    float32 array: the network viewer's render."""
    p = state.params
    out = rasterize(
        p.xyz, gm.get_opacity(p)[:, 0], camera,
        shs=gm.get_shs(p), sh_degree=sh_degree,
        scales=gm.get_scaling(p), rotations=gm.get_rotation(p),
        active_mask=state.alive, config=config or RasterConfig(),
    )
    return out.color.clamp(0.0, 1.0).cpu().numpy()


@dataclasses.dataclass
class OrbitState:
    """Orbit camera state: a camera on a sphere around ``center``."""

    center: np.ndarray
    radius: float = 4.0
    azimuth: float = 0.0
    elevation: float = 0.0
    fovy: float = 0.8
    width: int = 800
    height: int = 600

    def rotate(self, d_az: float, d_el: float) -> None:
        self.azimuth += d_az
        self.elevation = float(np.clip(self.elevation + d_el, -1.5, 1.5))

    def zoom(self, factor: float) -> None:
        self.radius = float(np.clip(self.radius * factor, 0.05, 100.0))

    def pan(self, dx: float, dy: float) -> None:
        self.center = self.center + np.array([dx, dy, 0.0]) * self.radius * 0.1

    def params(self) -> CameraParams:
        return orbit_camera_params(self.center, self.radius, self.azimuth, self.elevation,
                                   self.fovy, self.width, self.height)


def cluster_palette(k: int, generator: Optional[torch.Generator] = None) -> np.ndarray:
    """(k, 3) colors in [0.2, 1) for the cluster overlay, drawn from
    ``generator`` (a CPU generator seeded 7 by default)."""
    g = generator if generator is not None else torch.Generator().manual_seed(7)
    return (0.2 + 0.8 * torch.rand((k, 3), generator=g, device=g.device)).cpu().numpy()


class SagaSession:
    """Headless interactive segmentation over a trained scene and its
    affinity-feature field; everything lives on the scene state's device."""

    def __init__(
        self,
        scene_state: gm.GaussianState,
        feature_state: fgm.FeatureState,
        gate_params: ScaleGateParams,
        scale_qt,  # ops.quantile.QuantileTransform over the mask scales
        config: RasterConfig = RasterConfig(),
        seed: int = 0,
    ):
        self.scene_state = scene_state
        self.feature_state = feature_state
        self.gate = gate_params
        # Stored and never read, as in the JAX session: the slider's value is
        # already a quantile in [0, 1], so nothing maps a scale through it.
        self.qt = scale_qt
        self.config = config
        self.device = scene_state.params.xyz.device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # Orbit around the centroid of the live points.
        alive = scene_state.alive
        xyz = torch.where(alive[:, None], scene_state.params.xyz, 0.0)
        centroid = xyz.sum(dim=0) / alive.sum().clamp_min(1)
        self.orbit = OrbitState(center=centroid.cpu().numpy())
        self.scale = 0.5  # the slider's value, in [0, 1] quantile space
        self.threshold = 0.75
        self.chosen_features: list[torch.Tensor] = []
        self._undo: list[tuple[torch.Tensor, torch.Tensor]] = []
        self._pca_proj: Optional[torch.Tensor] = None
        self.cluster_centers: Optional[torch.Tensor] = None

    # ---------------- rendering ----------------

    def _gated_gaussian_features(self) -> torch.Tensor:
        """Every Gaussian's feature smoothed over all K neighbours, then
        scale-gated and normalised."""
        feats = fgm.smoothed_point_features(self.feature_state)
        return queries.gate_features(feats, self.gate, self.scale)

    @torch.no_grad()
    def render_rgb(self, cam: Optional[CameraParams] = None) -> np.ndarray:
        """(H, W, 3) host frame, SH degree 0, clamped to [0, 1]."""
        return render_view(self.scene_state, cam or self.orbit.params(), sh_degree=0,
                           config=self.config)

    @torch.no_grad()
    def render_feature_map(self, cam: Optional[CameraParams] = None) -> torch.Tensor:
        """(H, W, D) gated feature map on the session's device, zero
        background."""
        cam = cam or self.orbit.params()
        geom = self.feature_state.geom
        gated = self._gated_gaussian_features()
        out = rasterize(
            geom.xyz, fgm.get_opacity(geom)[:, 0], cam, colors=gated,
            scales=fgm.get_scaling(geom), rotations=fgm.get_rotation(geom),
            bg=torch.zeros(gated.shape[-1], device=self.device),
            active_mask=geom.alive, config=self.config,
        )
        return out.color

    @torch.no_grad()
    def render_pca(self, cam: Optional[CameraParams] = None,
                   indices: Optional[torch.Tensor] = None) -> np.ndarray:
        """(H, W, 3) PCA preview of the feature map.  The projection comes
        from the first frame rendered (over its pixels, or a drawn subsample
        of them, or ``indices``) and is kept for the session."""
        fmap = self.render_feature_map(cam)
        if self._pca_proj is None:
            self._pca_proj = queries.feature_pca(
                fmap.reshape(-1, fmap.shape[-1]), generator=self.generator, indices=indices)
        return queries.apply_pca(fmap, self._pca_proj).cpu().numpy()

    @torch.no_grad()
    def render_similarity(self, cam: Optional[CameraParams] = None) -> np.ndarray:
        """(H, W) score map: each pixel's largest cosine to the prompts;
        zeros before any click (then nothing is rendered)."""
        cam = cam or self.orbit.params()
        if not self.chosen_features:
            return np.zeros((cam.height, cam.width), np.float32)
        fmap = queries.normalize(self.render_feature_map(cam))
        prompts = torch.stack(self.chosen_features)
        with ieee_fp32_matmul():
            score = torch.einsum("hwc,pc->hwp", fmap, prompts).amax(dim=-1)
        return score.cpu().numpy()

    @torch.no_grad()
    def render_cluster(self, cam: Optional[CameraParams] = None,
                       palette: Optional[np.ndarray] = None) -> np.ndarray:
        """(H, W, 3) cluster-id colors: each pixel's nearest normalised
        cluster center (clustering first if there are none)."""
        if self.cluster_centers is None:
            self.cluster_in_3d()
        fmap = queries.normalize(self.render_feature_map(cam))
        with ieee_fp32_matmul():
            labels = torch.argmax(torch.einsum("hwc,kc->hwk", fmap, self.cluster_centers), dim=-1)
        if palette is None:
            palette = cluster_palette(self.cluster_centers.shape[0])
        return np.asarray(palette)[labels.cpu().numpy()]

    # ---------------- interaction ----------------

    @torch.no_grad()
    def click(self, x: int, y: int, cam: Optional[CameraParams] = None) -> None:
        """Record the clicked pixel's normalised gated feature as a prompt."""
        fmap = self.render_feature_map(cam)
        self.chosen_features.append(queries.normalize(fmap[y, x]))

    def clear_clicks(self) -> None:
        self.chosen_features = []

    @torch.no_grad()
    def cluster_in_3d(self, k: int = 32, indices: Optional[torch.Tensor] = None,
                      init_centers: Optional[torch.Tensor] = None) -> None:
        """Spherical k-means on a 2 % subsample of the live Gaussians' gated
        features (``indices`` into the live rows and ``init_centers`` replace
        the draws)."""
        gated = self._gated_gaussian_features()
        alive_idx = torch.nonzero(self.feature_state.geom.alive).flatten()
        self.cluster_centers = clustering.cluster_features(
            gated[alive_idx], k=min(k, alive_idx.numel()), sample_rate=0.02,
            generator=self.generator, indices=indices, init_centers=init_centers)

    @torch.no_grad()
    def segment3d(self) -> torch.Tensor:
        """Apply the prompts: returns the (capacity,) bool 3D mask and keeps
        only its Gaussians alive, with the previous state on the undo stack."""
        if not self.chosen_features:
            raise ValueError("segment3d needs at least one click")
        feats = fgm.smoothed_point_features(self.feature_state)
        mask = queries.segment3d(feats, self.gate, self.scale, torch.stack(self.chosen_features),
                                 threshold=self.threshold, alive=self.scene_state.alive)
        geom = self.feature_state.geom
        self._undo.append((self.scene_state.alive, geom.alive))
        self.scene_state = gm.segment(self.scene_state, mask)
        # The feature field's rows are the scene state's first rows; a loaded
        # scene's capacity may exceed them (queries.pad_to_alive).
        self.feature_state = self.feature_state._replace(
            geom=geom._replace(alive=geom.alive & mask[: geom.alive.shape[0]]))
        return mask

    def roll_back(self) -> None:
        """Undo the last segment3d (nothing to undo: no change)."""
        if not self._undo:
            return
        scene_alive, feat_alive = self._undo.pop()
        self.scene_state = self.scene_state._replace(alive=scene_alive)
        self.feature_state = self.feature_state._replace(
            geom=self.feature_state.geom._replace(alive=feat_alive))

    def save_mask(self, name: str = "final_mask", out_dir: str = "./segmentation_res") -> str:
        """Write the live set as a bool tensor over the whole capacity."""
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{name}.pt")
        torch.save(self.scene_state.alive.cpu(), path)
        return path
