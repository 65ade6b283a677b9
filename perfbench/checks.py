"""The numbers that decide ``correct``: the program's readings against the
reference's (``perfbench/reference``), each a gap that is 0 when they agree."""

from __future__ import annotations

import statistics

import numpy as np


def loss_gap(program: list, reference: list) -> float:
    """The largest relative gap of a step's loss."""
    return max(abs(p - r) / max(abs(r), 1e-12) for p, r in zip(program, reference, strict=True))


def worst_leaf_gap(program: dict, reference: dict, leaves=None) -> float:
    """Over the leaves, the gap between the program's norm and the
    reference's, against the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    leaves = list(reference) if leaves is None else list(leaves)
    median = statistics.median(reference[k] for k in reference)
    return max(abs(program[k] - reference[k]) / max(reference[k], median, 1e-30) for k in leaves)


def moving_leaves(ref_grads: dict) -> list:
    """Leaves whose reference gradient is at least a thousandth of the median
    leaf's: the others move under Adam by round-off alone."""
    median = statistics.median(ref_grads.values())
    return [k for k, v in ref_grads.items() if v >= 1e-3 * median]


def values_off_share(program: np.ndarray, reference: np.ndarray, tol: float) -> float:
    """Share of values that differ by more than ``tol``."""
    return float(np.mean(np.abs(np.asarray(program, np.float64) - np.asarray(reference, np.float64))
                         > tol))


def mask_off_share(program: np.ndarray, score: np.ndarray, threshold: float, tol: float) -> float:
    """Share of Gaussians whose membership differs from the reference's
    where the reference's score lies more than ``tol`` from the threshold:
    a score within rounding of it may fall either way."""
    want = score > threshold
    return float(np.mean((np.asarray(program) != want) & (np.abs(score - threshold) > tol)))
