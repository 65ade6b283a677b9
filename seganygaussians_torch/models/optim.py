"""Masked per-group Adam with row-level state surgery.

Counterpart of ``seganygaussians_tpu/models/optim.py``.  Six parameter groups
with their own learning rates go through one Adam (eps 1e-15, the 3DGS
setting), and optimizer state is edited when Gaussians appear or are
replaced: fresh rows get zero moments, and the opacity reset zeroes the
opacity moments.  Capacity is fixed, so that surgery is a masked row write.

The state is a NamedTuple of tensors with the parameters' structure (not
``torch.optim``, whose per-parameter state dicts make row surgery awkward).
Functions return new tuples; ``adam_update`` computes new tensors and does
not modify its inputs.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch


class AdamState(NamedTuple):
    mu: Any  # NamedTuple of tensors like the params
    nu: Any  # NamedTuple of tensors like the params
    count: torch.Tensor  # () int32


def _map(fn, *trees):
    return type(trees[0])(*(fn(*leaves) for leaves in zip(*trees)))


def adam_init(params: Any) -> AdamState:
    return AdamState(
        mu=_map(torch.zeros_like, params),
        nu=_map(torch.zeros_like, params),
        count=torch.zeros((), dtype=torch.int32, device=params[0].device),
    )


def adam_update(
    grads: Any,
    state: AdamState,
    params: Any,
    lrs: Any,  # NamedTuple of scalar learning rates (floats or 0-d tensors)
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-15,
) -> tuple[Any, AdamState]:
    """One bias-corrected Adam step (torch.optim.Adam semantics, eps outside
    the square root); returns (new_params, new_state)."""
    count = state.count + 1
    t = count.to(torch.float32)
    mu = _map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = _map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
    bc1 = 1 - b1**t
    bc2 = 1 - b2**t

    def step(p, m, v, lr):
        return p - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)

    new_params = _map(step, params, mu, nu, lrs)
    return new_params, AdamState(mu=mu, nu=nu, count=count)


def _zero_masked(leaf: torch.Tensor, row_mask: torch.Tensor) -> torch.Tensor:
    mask = row_mask.reshape((-1,) + (1,) * (leaf.dim() - 1))
    return torch.where(mask, torch.zeros_like(leaf), leaf)


def zero_rows(state: AdamState, row_mask: torch.Tensor) -> AdamState:
    """Zero the moments at rows where ``row_mask`` is True (freshly
    allocated or replaced Gaussians)."""
    return AdamState(
        mu=_map(lambda m: _zero_masked(m, row_mask), state.mu),
        nu=_map(lambda v: _zero_masked(v, row_mask), state.nu),
        count=state.count,
    )


def zero_leaf_rows(state: AdamState, leaf_name: str, row_mask: torch.Tensor) -> AdamState:
    """Zero the moments of ONE named leaf at masked rows (the opacity reset)."""
    return AdamState(
        mu=state.mu._replace(**{leaf_name: _zero_masked(getattr(state.mu, leaf_name), row_mask)}),
        nu=state.nu._replace(**{leaf_name: _zero_masked(getattr(state.nu, leaf_name), row_mask)}),
        count=state.count,
    )


def expon_lr(
    step: int,
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1_000_000,
) -> float:
    """Log-linear learning-rate schedule (Plenoxels/JaxNeRF), on the host:
    the step is a Python int, so the result is a float."""
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    if step < 0:
        return 0.0
    if lr_delay_steps > 0:
        delay = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
            0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0)
        )
    else:
        delay = 1.0
    t = min(max(step / max_steps, 0.0), 1.0)
    return delay * math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)
