"""Feature smoothing on Hopper: the K-neighbour gather-mean as one
hand-written CUDA kernel pair, the map's reverse that its backward reads, and
the kernels' plain versions.

``csrc/smooth.cu`` holds two kernels built into one library through
:class:`blend_cuda._CudaKernel`.  The forward computes, for every point i,
the mean over a neighbour map's columns (the drawn ``cols``, or all K) of the
normalised features of the points that row i names, reading those rows in
place: no (N, K, D) gather exists.  It writes the mean, or adds it to what the
output holds, so the levels of the multi-resolution smoothing sum in one
output.  The backward sums, for every source row j, the upstream gradient of
each point whose row names j, through the map's reverse
(:func:`reverse_map`: for each j the positions i·K + c that name it, in order),
and applies the normalisation's Jacobian at j: no atomics, one fixed order.

Two normalisations, as the two smoothers write them:
``"traditional"``, x·rsqrt(Σx² + 1e-12), and ``"multi_res"``, x / max(‖x‖,
1e-9).  The kernels take D a multiple of 4 up to 128 and maps up to 64
columns wide; :func:`smooth_mean` pads narrower rows with zero columns to a
multiple of 4 (a zero adds nothing to a norm or a mean), and a CUDA tensor
goes through the kernels or raises.  The callers in
``models/feature_gaussians.py`` keep their plain path for CPU tensors.
:func:`smooth_forward_plain` and :func:`smooth_backward_plain` repeat the
kernels' functions in PyTorch (the backward's through the reverse map) for
the CPU tests.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from seganygaussians_torch.ops import blend_cuda
from seganygaussians_torch.ops.blend_cuda import _INT, _PTR
from seganygaussians_torch.utils import tracing

NORMS = ("traditional", "multi_res")  # kernel instance = index: csrc/smooth.cu's NORM_*
MAX_K = 64  # map columns the backward's column weights hold
MAX_D = 128  # four float4s a lane, eight lanes a row


class ReverseMap(NamedTuple):
    """A neighbour map (N, K) turned round: the positions p = i·K + c whose
    entry is j are ``entries[offsets[j]:offsets[j + 1]]``, ascending."""

    offsets: torch.Tensor  # (N + 1,) int32
    entries: torch.Tensor  # (N·K,) int32


def reverse_map(nbrs: torch.Tensor) -> ReverseMap:
    """The reverse of a map of row indices in [0, N): a stable sort of its
    entries, so that positions naming the same row keep their (i, c) order,
    and the offsets by binary search (no count is read back to the host)."""
    n, k = nbrs.shape
    if n * k >= 2**31:
        raise ValueError(f"a map of {n}×{k} positions does not fit int32 entries")
    keys, order = torch.sort(nbrs.reshape(-1).to(torch.int32), stable=True)
    rows = torch.arange(n + 1, dtype=torch.int32, device=nbrs.device)
    offsets = torch.searchsorted(keys, rows, out_int32=True)
    return ReverseMap(offsets=offsets, entries=order.to(torch.int32))


class _SmoothKernel(blend_cuda._CudaKernel):
    stem = "smooth"
    count_keys = tuple(range(len(NORMS)))

    def _dims(self, pf: torch.Tensor, nbrs: torch.Tensor, cols: Optional[torch.Tensor]):
        """(N, D, K, K') after the checks that raise on what the kernels do not take."""
        n, d = pf.shape
        if d % 4 or not 0 < d <= MAX_D:
            raise ValueError(f"{self.name} kernel: {d} channels, takes a multiple of 4 up to {MAX_D}")
        if nbrs.dim() != 2 or nbrs.shape[0] != n or not 0 < nbrs.shape[1] <= MAX_K:
            raise ValueError(f"{self.name} kernel: map shape {tuple(nbrs.shape)} for {n} points "
                             f"(at most {MAX_K} columns)")
        if pf.data_ptr() % 16:
            raise ValueError(f"{self.name} kernel: features not 16-byte aligned")
        k = nbrs.shape[1]
        kd = k if cols is None else cols.numel()
        if kd < 1:
            raise ValueError(f"{self.name} kernel: no columns drawn")
        return n, d, k, kd


class ForwardKernel(_SmoothKernel):
    """``csrc/smooth.cu:smooth_fwd_kernel``."""

    name = "smooth_fwd"
    argtypes = [_INT, _INT, _INT, _PTR, _PTR, _INT, _PTR, _INT, _PTR, _INT, _PTR]

    def __call__(self, pf, nbrs, cols, out, norm: str, accumulate: bool) -> None:
        """out (+)= the mean over ``nbrs``' columns ``cols`` (or all) of the
        normalised rows of ``pf`` that they name."""
        tensors = {"pf": pf, "nbrs": nbrs, "out": out}
        if cols is not None:
            tensors["cols"] = cols
        self._check(tensors, {"nbrs": torch.int64, "cols": torch.int64}, pf.device)
        n, d, k, kd = self._dims(pf, nbrs, cols)
        if out.shape != pf.shape:
            raise ValueError(f"{self.name} kernel: out shape {tuple(out.shape)}, needs {tuple(pf.shape)}")
        self._launch(NORMS.index(norm), n, pf.device, n, d, pf.data_ptr(), nbrs.data_ptr(), k,
                     None if cols is None else cols.data_ptr(), kd, out.data_ptr(),
                     int(accumulate))


class BackwardKernel(_SmoothKernel):
    """``csrc/smooth.cu:smooth_bwd_kernel``."""

    name = "smooth_bwd"
    argtypes = [_INT, _INT, _INT, _PTR, _PTR, _PTR, _PTR, _INT, _PTR, _INT, _PTR, _INT, _PTR]

    def __call__(self, pf, grad_out, nbrs, reverse: ReverseMap, cols, grad_pf, norm: str,
                 accumulate: bool) -> None:
        """grad_pf (+)= the gradient, through the forward over ``nbrs``, of
        Σ grad_out·out; ``reverse`` is ``reverse_map(nbrs)``."""
        tensors = {"pf": pf, "grad_out": grad_out, "offsets": reverse.offsets,
                   "entries": reverse.entries, "grad_pf": grad_pf}
        if cols is not None:
            tensors["cols"] = cols
        self._check(tensors, {"offsets": torch.int32, "entries": torch.int32,
                              "cols": torch.int64}, pf.device)
        n, d, k, kd = self._dims(pf, nbrs, cols)
        if grad_out.shape != pf.shape or grad_pf.shape != pf.shape:
            raise ValueError(f"{self.name} kernel: gradient shapes {tuple(grad_out.shape)}, "
                             f"{tuple(grad_pf.shape)}, need {tuple(pf.shape)}")
        if reverse.offsets.shape != (n + 1,) or reverse.entries.shape != (n * k,):
            raise ValueError(f"{self.name} kernel: reverse map of {tuple(reverse.offsets.shape)}"
                             f" offsets and {tuple(reverse.entries.shape)} entries for a "
                             f"{n}×{k} map")
        self._launch(NORMS.index(norm), n, pf.device, n, d, pf.data_ptr(), grad_out.data_ptr(),
                     reverse.offsets.data_ptr(), reverse.entries.data_ptr(), k,
                     None if cols is None else cols.data_ptr(), kd, grad_pf.data_ptr(),
                     int(accumulate))


FORWARD = ForwardKernel()
BACKWARD = BackwardKernel()

# level(i, nbrs): a context manager round level i's launch (its span and row count).
LevelScope = Callable[[int, torch.Tensor], contextlib.AbstractContextManager]


def _forward(pf, maps, norm, cols, level: Optional[LevelScope]) -> torch.Tensor:
    out = torch.empty_like(pf)
    for i, nbrs in enumerate(maps):
        with level(i, nbrs) if level is not None else contextlib.nullcontext():
            FORWARD(pf, nbrs, cols, out, norm, accumulate=i > 0)
    return out


class _Smooth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pf, maps, norm, cols, reverse, level):
        out = _forward(pf, maps, norm, cols, level)
        built = reverse is None
        if built:
            reverse = tuple(reverse_map(nbrs) for nbrs in maps)
        tracing.count("smoothing.reverse_builds", len(maps) if built else 0)
        ctx.save_for_backward(pf)
        ctx.static = (maps, norm, cols, reverse)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        (pf,) = ctx.saved_tensors
        maps, norm, cols, reverse = ctx.static
        grad_out = grad_out.contiguous()
        grad = torch.empty_like(pf)
        for i, (nbrs, rev) in enumerate(zip(maps, reverse)):
            BACKWARD(pf, grad_out, nbrs, rev, cols, grad, norm, accumulate=i > 0)
        return grad, None, None, None, None, None


def smooth_mean(
    pf: torch.Tensor,
    maps: Sequence[torch.Tensor],
    norm: str,
    cols: Optional[torch.Tensor] = None,
    reverse: Optional[Sequence[ReverseMap]] = None,
    level: Optional[LevelScope] = None,
) -> torch.Tensor:
    """Σ over ``maps`` of the mean over each map's columns (``cols``, or all)
    of the ``norm``-normalised rows of ``pf`` (N, D) that it names, by the
    forward kernel, one launch a map (inside ``level(i, map)``).
    Differentiable in ``pf`` through the backward kernel, which reads each
    map's reverse from ``reverse`` (one a map, as :func:`reverse_map` gives
    them), or builds them at this call (counted in the traced counter
    ``smoothing.reverse_builds``).  D not a multiple of 4 (a session at
    C = 6) runs on the rows padded with zero columns."""
    if norm not in NORMS:
        raise ValueError(f"unknown normalisation {norm!r}")
    maps = tuple(m if m.dtype == torch.int64 else m.long() for m in maps)
    if reverse is not None and len(reverse) != len(maps):
        raise ValueError(f"{len(reverse)} reverse maps for {len(maps)} maps")
    d = pf.shape[1]
    pf = torch.nn.functional.pad(pf, (0, -d % 4)) if d % 4 else pf.contiguous()
    if torch.is_grad_enabled() and pf.requires_grad:
        out = _Smooth.apply(pf, maps, norm, cols, None if reverse is None else tuple(reverse),
                            level)
    else:
        out = _forward(pf, maps, norm, cols, level)
    return out[:, :d] if d % 4 else out


def smooth_forward_plain(pf: torch.Tensor, nbrs: torch.Tensor, cols: Optional[torch.Tensor],
                         norm: str) -> torch.Tensor:
    """The forward kernel's function in plain PyTorch, for one map: the mean
    over ``nbrs``' columns ``cols`` (or all) of the normalised rows they name,
    through the (N, K', D) gather the kernel does without.  The smoothers'
    path for CPU tensors, differentiable by autograd."""
    return torch.mean(normalise_plain(pf, norm)[nbrs if cols is None else nbrs[:, cols]], dim=1)


def normalise_plain(pf: torch.Tensor, norm: str) -> torch.Tensor:
    """The rows of ``pf`` normalised as the ``norm`` smoother writes it."""
    if norm == "traditional":
        return pf * torch.rsqrt(torch.sum(pf * pf, dim=-1, keepdim=True) + 1e-12)
    return pf / torch.linalg.norm(pf, dim=-1, keepdim=True).clamp_min(1e-9)


def normalise_backward_plain(pf: torch.Tensor, gy: torch.Tensor, norm: str) -> torch.Tensor:
    """The gradient of the ``norm`` normalisation at ``pf`` given its output's
    gradient ``gy``, formula for formula as ``csrc/smooth.cu:normalise_vjp``
    writes it (autograd's through the plain path)."""
    s = torch.sum(pf * pf, dim=-1, keepdim=True)
    t = torch.sum(gy * pf, dim=-1, keepdim=True)
    if norm == "traditional":
        r = torch.rsqrt(s + 1e-12)
        gs = (-0.5 * t) * ((r * r) * r)
        return gy * r + (gs * pf + gs * pf)
    nrm = torch.sqrt(s)
    d = nrm.clamp_min(1e-9)
    q = torch.where(nrm >= 1e-9, -(t / (d * d)) / nrm, torch.zeros_like(nrm))
    return gy / d + pf * q


def smooth_backward_plain(
    pf: torch.Tensor,
    grad_out: torch.Tensor,
    k: int,
    reverse: ReverseMap,
    cols: Optional[torch.Tensor],
    norm: str,
) -> torch.Tensor:
    """The backward kernel's function in plain PyTorch, on any device: for
    each row j, the sum over the positions p = i·K + c that the reverse map
    lists for it of grad_out[i] times how often column c is drawn, over the
    number of columns drawn, then the normalisation's gradient at pf[j]."""
    n = pf.shape[0]
    counts = torch.ones(k, dtype=pf.dtype, device=pf.device) if cols is None else \
        torch.bincount(cols.long(), minlength=k).to(pf.dtype)
    kd = k if cols is None else cols.numel()
    pos = reverse.entries.long()
    i, c = pos // k, pos % k
    rows = torch.repeat_interleave(torch.arange(n, device=pf.device),
                                   torch.diff(reverse.offsets.long()))
    summed = torch.zeros_like(pf).index_add_(0, rows, counts[c][:, None] * grad_out[i])
    return normalise_backward_plain(pf, summed / kd, norm)
