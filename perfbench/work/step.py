"""Modelled work of one step or request: the blend kernels' counts
(``work/blend.py``) plus what each other stage must read and write once.

Every term is a floor: a byte that a stage must read or write at least once,
an operation that the mathematics needs.  So the least time the card could
take, and the share of it that a measured step reaches, bound the step from
below whatever the program's kernels.
"""

from __future__ import annotations

from perfbench.work import blend

PARAMS = 59  # float32 parameters of a Gaussian: xyz 3, SH 48, scale 3, rotation 4, opacity 1
GEOMETRY = 11  # xyz, log-scale, rotation, opacity: what a feature render reads
F32 = 4


def _add(*terms):
    return sum(t[0] for t in terms), sum(t[1] for t in terms)


def scene_train(n: int, fwd: blend.Frame) -> tuple[float, float]:
    """A 3DGS training step over ``n`` Gaussians on the view of ``fwd``."""
    per_gaussian = PARAMS * F32 * (
        1  # the parameters, read by projection and SH
        + 1  # their gradient, written by the backward
        + 4 + 3  # Adam: parameters, gradient and two moments read; three written
    )
    image = fwd.pixels * 3 * F32 * 3  # L1 + SSIM: render and ground truth read, gradient written
    # Operations: projection and EWA covariance about 150 a Gaussian, SH to
    # degree 3 about 130, their gradients about twice that, Adam 10 a
    # parameter; SSIM 5 maps blurred twice by 11 taps, 2 operations a tap.
    ops = n * (150 + 130) * 3 + n * PARAMS * 10 + fwd.pixels * 3 * 5 * 2 * 11 * 2
    return _add((n * per_gaussian + image, ops), blend.forward(fwd), blend.backward(fwd))


def smoothing(n: int, k: int, d: int, backward: bool) -> tuple[float, float]:
    """The K-neighbour mean of normalised features: the K neighbours' rows
    gathered, the mean written; its backward reads that gradient and adds K
    rows' worth into the features' gradient."""
    fwd = (n * (k + 2) * d * F32, n * d * (k + 3))
    if not backward:
        return fwd
    return _add(fwd, (n * (k + 2) * d * F32, n * d * (k + 3)))


def feature_train(n: int, cols: list[int], sums: int, d: int, rays: int, scales: int,
                  fwd: blend.Frame) -> tuple[float, float]:
    """A contrastive step: smoothing and its backward, once for each entry of
    ``cols``, the neighbour columns a level averages over (traditional:
    ``[⌊K·dropout⌋]``; multi-resolution: one entry a level), and ``sums``
    additions of N·d that put the levels together (operations only: a fused
    sum writes nothing more); the geometry read, the C = d blend forward and
    backward, the ray correlations (S, R, R) and their gradient, Adam over
    the features."""
    adam = (n * d * F32 * 7, n * d * 10)
    corr = (scales * rays * rays * F32 * 4, scales * rays * rays * d * 2 * 3)
    return _add(*(smoothing(n, k, d, True) for k in cols), (0, sums * n * d),
                (n * GEOMETRY * F32, 0), adam, corr, blend.forward(fwd), blend.backward(fwd))


def feature_request(n: int, k: int, d: int, fwd: blend.Frame, similarity: bool):
    """A session frame or click: smoothing over all K, the gate, the C = d
    render and, for a similarity frame, the score map written."""
    score = (fwd.pixels * d * F32 + fwd.pixels * F32, fwd.pixels * d * 2) if similarity else (0, 0)
    return _add(smoothing(n, k, d, False), (n * (GEOMETRY + d) * F32, n * d * 4), score,
                blend.forward(fwd))


def segment3d(n: int, k: int, d: int) -> tuple[float, float]:
    """``segment3d``: smoothing, gate, a similarity per Gaussian, the mask."""
    return _add(smoothing(n, k, d, False), (n * d * F32 + n, n * d * 6))
