"""Operations and bytes of the blend kernels on one frame, and the least time
the card could take for them.

The counts come from the benchmark's own reference binning and blend of the
same inputs (``perfbench/reference/render.py``), so they are the work that
these inputs need, whatever plan or kernel the program uses.  Each input byte
is counted read once and each output byte written once; pairs are counted
over the image's pixels only.
"""

from __future__ import annotations

from typing import NamedTuple

# NVIDIA H100 SXM data sheet: HBM3 3.35 TB/s; float32 outside the tensor
# cores 67 TFLOP/s (dense, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


class Frame(NamedTuple):
    """What one frame's blend has to do."""

    instances: int  # (Gaussian, tile) pairs in the tile lists
    tiles: int
    gaussians: int  # distinct Gaussians with an instance
    pixels: int  # width × height
    channels: int
    visited: int  # (instance, pixel) pairs evaluated up to each pixel's stop
    included: int  # pairs that contribute


def forward(f: Frame) -> tuple[float, float]:
    """(bytes, operations) of the forward blend."""
    c = f.channels
    bytes_moved = (
        f.instances * 8  # an int64 Gaussian index per instance
        + (f.tiles + 1) * 4  # the tile ranges
        + f.gaussians * (6 + c) * 4  # mean, conic, opacity, colour of each Gaussian used
        + c * 4  # background
        + f.pixels * (c + 2) * 4  # colour, final T and the contribution count written
    )
    # 14 fp32 operations per visited pair (offsets, quadratic form, exp,
    # opacity, clamp, tests) and 2·C + 3 per included pair (transmittance,
    # weight, colour accumulation).
    ops = 14 * f.visited + (2 * c + 3) * f.included
    return float(bytes_moved), float(ops)


def backward(f: Frame) -> tuple[float, float]:
    """(bytes, operations) of the backward blend."""
    c = f.channels
    bytes_moved = (
        f.instances * 8 + (f.tiles + 1) * 4 + f.gaussians * (6 + c) * 4 + c * 4  # as forward
        + f.pixels * (2 * c + 2) * 4  # forward colour and final T; their cotangents
        + f.gaussians * (6 + c) * 4  # the per-Gaussian gradient written
    )
    # 14 per visited pair (the forward's alpha again); per included pair
    # 3·C + 29 for the gradient terms (g·c, suffix, dL/dα, the mean, conic,
    # opacity and colour partials, transmittance) and 6 + C adds to sum them
    # over the tile's pixels.
    ops = 14 * f.visited + (4 * c + 35) * f.included
    return float(bytes_moved), float(ops)


def least_seconds(bytes_moved: float, ops: float) -> float:
    """The larger of bytes over the card's bandwidth and operations over its
    float32 rate."""
    return max(bytes_moved / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S)


def count(bins, frame, width: int, height: int, channels: int) -> Frame:
    """The :class:`Frame` of a reference binning (``reference.render.Bins``)
    and its blend (``reference.render.Frame``)."""
    gx, gy, _ = bins.grid
    return Frame(instances=int(bins.gauss.numel()), tiles=gx * gy,
                 gaussians=int(bins.gauss.unique().numel()), pixels=width * height,
                 channels=channels, visited=frame.visited, included=frame.included)
