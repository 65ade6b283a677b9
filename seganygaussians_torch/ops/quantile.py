"""Empirical quantile transform (sklearn QuantileTransformer replacement).

Counterpart of ``seganygaussians_tpu/ops/quantile.py``.  SAM-mask 3D scales
are normalised with a uniform-output quantile transform fitted on all
training scales: fit = ``n_quantiles`` evenly spaced empirical quantiles
(sorted-array gather), transform = piecewise-linear interpolation against
them, clamped at both ends like ``numpy.interp``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QuantileTransform(NamedTuple):
    quantiles: torch.Tensor  # (Q,) ascending reference values
    normal: bool  # True ⇒ gaussian output distribution


def _unit_linspace(q: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, q)`` to the bit: i times the fp32 reciprocal of
    q − 1 (``torch.linspace`` steps from both ends and rounds otherwise), so
    that knots which fall on whole positions do so in both packages."""
    step = torch.tensor(1.0 / (q - 1), dtype=torch.float32, device=device)
    out = torch.arange(q, dtype=torch.float32, device=device) * step
    out[-1] = 1.0
    return out


def fit_quantile_transform(
    values: torch.Tensor, n_quantiles: int = 1000, output: str = "uniform"
) -> QuantileTransform:
    v = torch.sort(values.reshape(-1).to(torch.float32)).values
    n = v.shape[0]
    q = max(2, min(n_quantiles, n))
    pos = _unit_linspace(q, v.device) * (n - 1)
    lo = torch.floor(pos).long()
    hi = torch.ceil(pos).long()
    frac = pos - lo
    return QuantileTransform(
        quantiles=v[lo] * (1 - frac) + v[hi] * frac, normal=output == "normal"
    )


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp`` for ascending ``xp``: linear between the knots, ``fp[0]``
    below the first and ``fp[-1]`` above the last; inside a run of equal
    knots the value of the knot before the interval."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    flat = dx.abs() <= 1.4210855e-14  # np.spacing(np.finfo(np.float32).eps), as jnp.interp
    safe_dx = torch.where(flat, torch.ones_like(dx), dx)
    f = torch.where(flat, fp[i - 1], fp[i - 1] + (delta / safe_dx) * df)
    f = torch.where(x < xp[0], fp[0].expand_as(f), f)
    return torch.where(x > xp[-1], fp[-1].expand_as(f), f)


def apply_quantile_transform(qt: QuantileTransform, x: torch.Tensor) -> torch.Tensor:
    q = qt.quantiles.shape[0]
    refs = _unit_linspace(q, x.device)
    u = interp(x.reshape(-1), qt.quantiles, refs).reshape(x.shape)
    if not qt.normal:
        return u
    eps = 1e-7
    return torch.special.ndtri(torch.clamp(u, eps, 1 - eps))
