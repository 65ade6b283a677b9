"""3DGS scene training loop.

Counterpart of ``seganygaussians_tpu/train/scene_trainer.py``.  One iteration
(:func:`train_step`) renders a view, takes L1 + SSIM against the ground
truth, differentiates with respect to the parameters and a zero
``ndc_offset`` (whose gradient is the view-space positional signal that
densification thresholds), applies masked Adam and accumulates densification
statistics.  Densify/prune and the opacity reset run on the reference's
cadence in :class:`SceneTrainer`.

On CUDA tensors the render's blend runs forward and backward through the two
Hopper kernels; on CPU tensors through the plain version.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from seganygaussians_torch.models import gaussians as gm
from seganygaussians_torch.models import optim
from seganygaussians_torch.ops import losses
from seganygaussians_torch.ops.binning import suggest_capacity
from seganygaussians_torch.ops.camera import CameraParams
from seganygaussians_torch.ops.rasterize import RasterConfig, rasterize
from seganygaussians_torch.utils import lpips_metric


def _render(params: gm.GaussianParams, alive, camera, bg, active_sh_degree, config,
            ndc_offset=None):
    return rasterize(
        params.xyz,
        gm.get_opacity(params)[:, 0],
        camera,
        shs=gm.get_shs(params),
        sh_degree=active_sh_degree,
        scales=gm.get_scaling(params),
        rotations=gm.get_rotation(params),
        bg=bg,
        ndc_offset=ndc_offset,
        active_mask=alive,
        config=config,
    )


def view_loss_and_grads(
    state: gm.GaussianState,
    camera: CameraParams,
    gt_image: torch.Tensor,  # (H, W, 3) on the state's device
    bg: torch.Tensor,  # (3,)
    active_sh_degree: int,
    hyper: gm.TrainHyper,
    config: RasterConfig,
):
    """One view's loss, (1 − λ)·L1 + λ·(1 − SSIM), and its gradients with
    respect to the parameters and to the screen-space means (the
    densification statistic).  Returns (loss, l1, parameter gradients, the
    means' gradient, radii, overflow), the losses detached."""
    leaves = [p.detach().requires_grad_(True) for p in state.params]
    params = gm.GaussianParams(*leaves)
    ndc0 = torch.zeros((params.xyz.shape[0], 2), device=params.xyz.device, requires_grad=True)
    out = _render(params, state.alive, camera, bg, active_sh_degree, config, ndc0)
    l1 = losses.l1_loss(out.color, gt_image)
    ssim_v = losses.ssim(out.color, gt_image)
    loss = (1.0 - hyper.lambda_dssim) * l1 + hyper.lambda_dssim * (1.0 - ssim_v)
    *param_grads, ndc_grad = torch.autograd.grad(loss, leaves + [ndc0])
    return loss.detach(), l1.detach(), param_grads, ndc_grad, out.radii, out.overflow


def train_step(
    state: gm.GaussianState,
    camera: CameraParams,
    gt_image: torch.Tensor,  # (H, W, 3) on the state's device
    bg: torch.Tensor,  # (3,)
    step: int,  # 1-based iteration
    spatial_lr_scale: float,
    active_sh_degree: int,
    hyper: gm.TrainHyper,
    config: RasterConfig,
) -> tuple[gm.GaussianState, dict]:
    """One train iteration.  Returns (new_state, metrics); ``loss``, ``l1``,
    ``n_alive`` and ``nonfinite`` are device tensors, ``overflow`` a bool."""
    loss, l1, param_grads, ndc_grad, radii, overflow = view_loss_and_grads(
        state, camera, gt_image, bg, active_sh_degree, hyper, config)

    with torch.no_grad():
        # Skip the update wholesale on a non-finite step (a corrupt pose or
        # image): one NaN gradient would otherwise poison the Adam moments and
        # every parameter for good, while the logged loss stays finite.
        finite = torch.isfinite(loss)
        for g in param_grads + [ndc_grad]:
            finite = finite & torch.isfinite(g).all()
        safe_grads = gm.GaussianParams(
            *(torch.where(finite, g, torch.zeros_like(g)) for g in param_grads)
        )
        lrs = gm.make_lr_tree(hyper, spatial_lr_scale, step)
        new_params, new_opt = optim.adam_update(safe_grads, state.opt, state.params, lrs)
        new_params = gm.GaussianParams(
            *(torch.where(finite, n, o) for n, o in zip(new_params, state.params))
        )
        state = state._replace(params=new_params, opt=new_opt)
        ndc_safe = torch.where(finite, ndc_grad, torch.zeros_like(ndc_grad))
        state = gm.add_densification_stats(state, ndc_safe, radii)
        metrics = {"loss": loss, "l1": l1, "overflow": overflow,
                   "n_alive": gm.num_alive(state), "nonfinite": ~finite}
    return state, metrics


def densify_step(
    state: gm.GaussianState,
    generator: torch.Generator,
    extent: float,
    max_screen: float,
    hyper: gm.TrainHyper,
) -> gm.GaussianState:
    with torch.no_grad():
        return gm.densify_and_prune(
            state,
            generator,
            max_grad=hyper.densify_grad_threshold,
            min_opacity=0.005,
            extent=extent,
            max_screen_size=max_screen,
            percent_dense=hyper.percent_dense,
        )


@dataclasses.dataclass
class SceneTrainer:
    """Host loop: a fresh random camera order per epoch, SH warm-up every 1000
    iterations, densification every ``densification_interval`` inside
    (densify_from, densify_until), opacity reset every
    ``opacity_reset_interval`` (and at densify_from on a white background),
    and a larger instance capacity after an overflow."""

    state: gm.GaussianState
    cameras: list  # objects with ``params`` (CameraParams) and ``image`` (H, W, 3)
    spatial_lr_scale: float
    hyper: gm.TrainHyper = gm.TrainHyper()
    sh_degree: int = 3
    white_background: bool = False
    config: RasterConfig = RasterConfig()
    seed: int = 0
    on_eval: Optional[Callable] = None
    # Fires every iteration (the save/test/checkpoint cadence hook).
    on_iteration: Optional[Callable] = None

    def __post_init__(self):
        self.device = self.state.alive.device
        self.active_sh_degree = 0
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self.bg = torch.tensor(
            [1.0, 1.0, 1.0] if self.white_background else [0.0, 0.0, 0.0],
            dtype=torch.float32, device=self.device,
        )
        self._stack: list[int] = []
        self._gt_cache: dict[int, torch.Tensor] = {}
        self.metrics_history: list[dict] = []
        # Every refill of the stack draws a fresh permutation.
        self._rng = np.random.default_rng(self.seed)

    def _to_device(self, image) -> torch.Tensor:
        return torch.tensor(np.asarray(image, np.float32), device=self.device)

    def _image(self, idx: int, cam) -> torch.Tensor:
        if idx not in self._gt_cache:
            self._gt_cache[idx] = self._to_device(cam.image)
        return self._gt_cache[idx]

    def _next_camera(self):
        if not self._stack:
            self._stack = list(self._rng.permutation(len(self.cameras)))
        idx = int(self._stack.pop())
        cam = self.cameras[idx]
        return cam, self._image(idx, cam)

    def _grow_capacity(self):
        new_cap = suggest_capacity(int(self.config.capacity * 1.5))
        print(f"[raster] instance overflow: capacity {self.config.capacity} -> {new_cap}")
        self.config = dataclasses.replace(self.config, capacity=new_cap)

    @property
    def extent(self) -> float:
        return self.spatial_lr_scale  # cameras_extent == spatial_lr_scale

    def run(self, iterations: Optional[int] = None, log_every: int = 0,
            start_iteration: int = 0):
        h = self.hyper
        iterations = iterations or h.iterations
        # SH warm-up state on resume: +1 degree per 1000 iterations.
        self.active_sh_degree = min(self.sh_degree, start_iteration // 1000)
        t0 = time.time()
        for it in range(start_iteration + 1, iterations + 1):
            if it % 1000 == 0 and self.active_sh_degree < self.sh_degree:
                self.active_sh_degree += 1
            cam, gt = self._next_camera()
            self.state, metrics = train_step(
                self.state, cam.params, gt, self.bg, it, self.spatial_lr_scale,
                self.active_sh_degree, h, self.config,
            )
            if metrics["overflow"]:
                self._grow_capacity()
            if bool(metrics["nonfinite"]):
                print(f"[ITER {it}] WARNING: non-finite loss/grads "
                      f"(camera '{getattr(cam, 'image_name', '?')}') — update skipped")
            # The opacity reset is not nested under the densify-from gate:
            # white-background scenes reset at exactly it == densify_from, and
            # periodic resets run for the whole it < densify_until window.
            if it < h.densify_until_iter:
                if it > h.densify_from_iter and it % h.densification_interval == 0:
                    max_screen = 20.0 if it > h.opacity_reset_interval else 0.0
                    self.state = densify_step(
                        self.state, self.generator, self.extent, max_screen, h
                    )
                if it % h.opacity_reset_interval == 0 or (
                    self.white_background and it == h.densify_from_iter
                ):
                    with torch.no_grad():
                        self.state = gm.reset_opacity(self.state)
            if self.on_iteration:
                self.on_iteration(self, it, metrics)
            if log_every and it % log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["iter"] = it
                m["elapsed_s"] = time.time() - t0
                self.metrics_history.append(m)
                if self.on_eval:
                    self.on_eval(self, it, m)
        return self.state

    def _eval_view(self, cam):
        """(l1, psnr, the clamped render) of one view."""
        return _eval_step(self.state, cam.params, self._to_device(cam.image), self.bg,
                          self.active_sh_degree, self.config)

    def psnr_on(self, cameras) -> float:
        """Mean PSNR over views."""
        return float(np.mean([float(self._eval_view(cam)[1]) for cam in cameras]))

    def eval_report(self, cameras, with_lpips: bool = False, lpips_net=None) -> dict:
        """Held-out L1 and PSNR, one render per view, and LPIPS when asked
        for: ``lpips`` is None when the ``lpips`` package is missing (and
        ``lpips_net``, a stand-in network, is not given)."""
        use_lpips = with_lpips and (lpips_net is not None or lpips_metric.lpips_available())
        if use_lpips and lpips_net is None:
            lpips_net = lpips_metric.load_net("alex", self.device)
        l1s, psnrs, lps = [], [], []
        for cam in cameras:
            l1, psnr, img = self._eval_view(cam)
            l1s.append(float(l1))
            psnrs.append(float(psnr))
            if use_lpips:
                lps.append(lpips_metric.lpips(img, self._to_device(cam.image), net=lpips_net))
        out = {"l1": float(np.mean(l1s)), "psnr": float(np.mean(psnrs))}
        if with_lpips:
            out["lpips"] = float(np.mean(lps)) if use_lpips else None
        return out


@torch.no_grad()
def _render_image(state: gm.GaussianState, camera, bg, active_sh_degree, config) -> torch.Tensor:
    return _render(state.params, state.alive, camera, bg, active_sh_degree, config).color


@torch.no_grad()
def _eval_step(state: gm.GaussianState, camera, gt, bg, active_sh_degree, config):
    """(L1, PSNR, the render clamped to [0, 1]) of one view against ``gt``."""
    img = torch.clamp(_render_image(state, camera, bg, active_sh_degree, config), 0.0, 1.0)
    return losses.l1_loss(img, gt), losses.psnr(img, gt), img
