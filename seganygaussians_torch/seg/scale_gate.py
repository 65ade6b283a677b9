"""Scale gate: 1 → feature_dim sigmoid linear gate over affinity features.

Counterpart of ``seganygaussians_tpu/seg/scale_gate.py``: the reference's
``nn.Sequential(nn.Linear(1, 32), nn.Sigmoid())`` trained jointly with the
features at the feature learning rate, and the fixed staircase gate used when
``scale_aware_dim`` ∈ (0, 32).  The saved file is the reference's state dict
(``0.weight``, ``0.bias``), so a gate saved by either package loads in the
other.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class ScaleGateParams(NamedTuple):
    w: torch.Tensor  # (1, D)
    b: torch.Tensor  # (D,)


def init_scale_gate(
    generator: torch.Generator, feature_dim: int = 32, device="cuda"
) -> ScaleGateParams:
    """torch Linear default init: U(-1/sqrt(in), 1/sqrt(in)) with in = 1."""
    def uniform(*shape):
        u = torch.rand(*shape, generator=generator, device=generator.device)
        return (2.0 * u - 1.0).to(device)

    return ScaleGateParams(w=uniform(1, feature_dim), b=uniform(feature_dim))


def apply_scale_gate(params: ScaleGateParams, scales: torch.Tensor) -> torch.Tensor:
    """scales (..., 1) → gates (..., D) in (0, 1).  The inner dimension is 1,
    so the product is written elementwise and stays fp32 on the card."""
    return torch.sigmoid(scales * params.w[0] + params.b)


def fixed_scale_gate(scale_aware_dim: int, feature_dim: int = 32, device="cuda") -> torch.Tensor:
    """Staircase gate table: row i keeps the first
    ``feature_dim - scale_aware_dim + i`` channels."""
    rows = []
    for i in range(scale_aware_dim + 1):
        keep = feature_dim - scale_aware_dim + i
        rows.append([1.0] * keep + [0.0] * (feature_dim - keep))
    return torch.tensor(np.array(rows, np.float32), device=device)


def save_scale_gate(path: str, params: ScaleGateParams) -> None:
    """The reference's ``scale_gate.pt`` state dict."""
    torch.save(
        {
            "0.weight": params.w.detach().cpu().T.contiguous(),
            "0.bias": params.b.detach().cpu().contiguous(),
        },
        path,
    )


def load_scale_gate(path: str, device="cuda") -> ScaleGateParams:
    sd = torch.load(path, map_location="cpu", weights_only=False)
    return ScaleGateParams(
        w=torch.as_tensor(np.asarray(sd["0.weight"]), dtype=torch.float32).T.contiguous().to(device),
        b=torch.as_tensor(np.asarray(sd["0.bias"]), dtype=torch.float32).to(device),
    )


def scale_gate_from_jax(fields, device="cuda") -> ScaleGateParams:
    """The JAX package's ``ScaleGateParams`` as numpy arrays (a mapping or a
    NamedTuple with ``w`` and ``b``) → the port's."""
    fields = fields._asdict() if hasattr(fields, "_asdict") else fields
    return ScaleGateParams(
        w=torch.tensor(np.asarray(fields["w"]), dtype=torch.float32, device=device),
        b=torch.tensor(np.asarray(fields["b"]), dtype=torch.float32, device=device),
    )
