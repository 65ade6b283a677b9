"""Training checkpoint / resume.

Counterpart of ``seganygaussians_tpu/checkpoint.py`` with the same layout:
``<dir>/ckpt_<iteration>`` holds the whole ``GaussianState`` (parameters,
alive mask, densification statistics, Adam moments) and
``<dir>/ckpt_<iteration>.meta.json`` the host-side counters (iteration, SH
degree).  The state is written with ``torch.save`` as a dictionary of CPU
tensors.  The JAX package writes orbax checkpoints, which this module cannot
read, and it cannot read these.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from seganygaussians_torch.models import gaussians as gm
from seganygaussians_torch.models import optim


def _to_dict(state: gm.GaussianState) -> dict:
    def tree(t):
        return {k: v.detach().cpu() for k, v in t._asdict().items()}

    out = {k: v.detach().cpu() for k, v in state._asdict().items()
           if isinstance(v, torch.Tensor)}
    out["params"] = tree(state.params)
    if state.opt is not None:
        out["opt"] = {"mu": tree(state.opt.mu), "nu": tree(state.opt.nu),
                      "count": state.opt.count.detach().cpu()}
    return out


def save_checkpoint(path: str, state: gm.GaussianState, iteration: int,
                    extra: Optional[dict] = None) -> str:
    """Save ``state`` + metadata under ``path/ckpt_<iteration>``."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    ckpt = os.path.join(path, f"ckpt_{iteration}")
    torch.save(_to_dict(state), ckpt)
    with open(os.path.join(path, f"ckpt_{iteration}.meta.json"), "w") as f:
        json.dump({"iteration": iteration, **(extra or {})}, f)
    return ckpt


def latest_iteration(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    iters = [
        int(d.split("_")[-1])
        for d in os.listdir(path)
        if d.startswith("ckpt_") and not d.endswith(".json")
    ]
    return max(iters) if iters else None


def load_checkpoint(path: str, template: gm.GaussianState,
                    iteration: Optional[int] = None) -> tuple[gm.GaussianState, dict]:
    """Restore (state, metadata).  ``template`` is a state of the same
    capacity; the restored tensors go to its device and must match its
    shapes."""
    path = os.path.abspath(path)
    if iteration is None:
        iteration = latest_iteration(path)
        if iteration is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    d = torch.load(os.path.join(path, f"ckpt_{iteration}"), map_location="cpu",
                   weights_only=True)
    device = template.alive.device

    def t(x, like):
        if like is not None and tuple(x.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint shape {tuple(x.shape)} != {tuple(like.shape)}")
        return x.to(device)

    def tree(src, like):
        return gm.GaussianParams(**{k: t(src[k], getattr(like, k)) for k in gm.GaussianParams._fields})

    state = gm.GaussianState(
        params=tree(d["params"], template.params),
        **{k: t(d[k], getattr(template, k)) for k in
           ("alive", "seg_mask", "max_radii2d", "xyz_grad_accum", "denom") if k in d},
    )
    if "opt" in d:
        state = state._replace(opt=optim.AdamState(
            mu=tree(d["opt"]["mu"], template.params),
            nu=tree(d["opt"]["nu"], template.params),
            count=d["opt"]["count"].to(device),
        ))
    meta_path = os.path.join(path, f"ckpt_{iteration}.meta.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return state, meta
