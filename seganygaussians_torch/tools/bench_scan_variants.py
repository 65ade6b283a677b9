"""Micro-benchmark of transmittance-scan strategies for the blend kernels:
which way of computing a cumulative product along the instance axis is
fastest on this card?

    python -m seganygaussians_torch.tools.bench_scan_variants

Counterpart of ``tools/bench_scan_variants.py`` of the JAX package.  All
variants loop ``n_chunk`` times over a (256, 256) fp32 block, in the
hand-written kernel ``csrc/scan_variants.cu``.  The chunks are coupled only
through ``acc[:, 0]``, so a call is three launches: the feedback chain
(``chain[i, r]``, row r's column-0 state before chunk i: one thread a row, or
for roll_sub one warp scanning column 0), the work on a grid of (tile, chunk
range) that fills the card with one partial a range, and the sum of the
partials in range order.  The work launches:

  exp_only    alpha = min(0.99, exp(s)) and a sum (no scan); a warp a row
  log_tri     log1p → strict-upper-triangular product on the tensor cores
              (``wgmma`` m64n64k8 TF32, fp32 accumulate) → exp; a
              warpgroup on 64 rows
  log_tri_hs  the same product compensated: hi = tf32(x), lo = tf32(x − hi),
              two products (the counterpart of the TPU's HIGHEST)
  roll_lane   Hillis-Steele product scan along K: a warp a row, 8 columns a
              lane, an in-lane running product and 5 shuffles
  roll_sub    the same scan along axis 0: a warp owns 8 columns and all 256
              rows of them, 8 rows a lane
  seq_march   one thread per row marching K in order (the inner loop of
              ``csrc/blend_fwd.cu``); computes roll_lane's function

``scan_variants_plain`` is the same loop in plain PyTorch for the tests and
the comparison on the card; ``feedback_chain_plain`` and its range form
(``chunk_range=``, ``chain=``) repeat the kernel's decomposition on the CPU.
The tool's timing never uses them.

Two floors stand beside each time.  ``bound_us`` counts the operations of the
function, the same for every variant that computes T_before, at the card's
peak rates.  ``chain_us`` measures the chain launch alone: chunk i's ``exp``
waits on chunk i − 1's ``acc[:, 0]``, a dependent chain no design overlaps
with itself, and every variant runs it before its work.  ``latency_floor_us``
is the estimate of that chain from its instructions (40-60 cycles a chunk at
the boost clock), kept beside the measurement.  ``_median_us_per_chunk``
times 10 calls a window, so the host's share of a call (its allocations and
launches) hides behind the card's work; ``tools/compare_scan_kernels.py``
times two builds of the kernel that way and with one call a window, as the
tool did before the chain design.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from seganygaussians_torch.ops.blend_cuda import _INT, _PTR, _CudaKernel

P, K, N_CHUNK = 256, 256, 1000
VARIANTS = ("exp_only", "log_tri", "log_tri_hs", "roll_lane", "roll_sub", "seq_march")

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor cores
# 67 TFLOP/s, over 132 SMs.
PEAK_FP32_PER_S = 67e12
NUM_SMS = 132
# The most chunk ranges of a call, which size the partials' scratch; the
# kernel checks the count it is given and owns its grid
# (``ScanKernel.grid_blocks``).
MAX_RANGES = 33
# Variants whose chain is column 0's scan down the rows; the others share
# the row recurrence a <- a + min(0.99, exp(s[r, 0] + 1e-6 a)).
SCAN_CHAIN = ("roll_sub",)
# Operations the function needs per element and chunk: (special-function
# calls, fp32 operations).  A bound counts the function's work, not the
# variant's way to it, so every variant that computes T_before counts the
# same: the one exp of alpha, the scan's one multiply of (1 - alpha) and the
# accumulate acc + alpha * T_before (a multiply and an add).  Hillis-Steele's
# extra passes, the triangular product and the log variants' log1p and second
# exp are ways to the same T_before and are not counted.  exp_only computes
# no T_before: its exp alone.
T_BEFORE_OPS = (1, 3)
OPS = {"exp_only": (1, 0), **{v: T_BEFORE_OPS for v in VARIANTS[1:]}}
SFU_OPS = 4  # a special-function call runs at a quarter of the fp32 rate
# The feedback chain between chunks (see the module docstring): an estimate
# from its instructions, in cycles, at the published boost clock.
CHAIN_CYCLES = (40, 60)
BOOST_CLOCK_HZ = 1.98e9


def n_ranges(n_chunk: int) -> int:
    """Chunk ranges (and partials) of a call: one range a chunk up to
    ``MAX_RANGES``, and one (empty) range for no chunk."""
    return max(1, min(MAX_RANGES, n_chunk))


def round_to_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 → TF32 (10 mantissa bits), round to nearest, ties away from zero:
    what ``cvt.rna.tf32.f32`` does to the tensor cores' inputs."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = tf32(x) and lo = tf32(x − hi): log_tri_hs's two
    tensor-core operands, whose sum keeps about 21 bits of x."""
    hi = round_to_tf32(x)
    return hi, round_to_tf32(x - hi)


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; choose from {VARIANTS}")


def feedback_chain_plain(s: torch.Tensor, variant: str, n_chunk: int) -> torch.Tensor:
    """(n_chunk, 256): row r's ``acc[r, 0]`` before chunk i, as the chain
    launch computes it, on any device.  The five row variants: column 0's
    T_before is exactly 1, so a <- a + min(0.99, exp(s[r, 0] + 1e-6 a)).
    roll_sub: column 0's exclusive product down the rows."""
    _check_variant(variant)
    s0 = s[:, 0]
    a = torch.zeros_like(s0)
    chain = s.new_empty((n_chunk, s.shape[0]))
    for i in range(n_chunk):
        chain[i] = a
        alpha = torch.clamp_max(torch.exp(s0 + a * 1e-6), 0.99)
        if variant in SCAN_CHAIN:
            incl = torch.cumprod(1.0 - alpha, dim=0)
            a = a + alpha * torch.cat([incl.new_ones(1), incl[:-1]])
        else:
            a = a + alpha
    return chain


def scan_variants_plain(s: torch.Tensor, variant: str, n_chunk: int,
                        tf32: bool = False, chunk_range: tuple[int, int] | None = None,
                        chain: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device.

    ``tf32=True`` rounds log_tri's ``log1p(-alpha)`` to TF32 before the sum,
    as the kernel's tensor-core product does.  The range form repeats one
    work block's share: with ``chunk_range=(c0, c1)`` and the feedback
    ``chain`` (:func:`feedback_chain_plain`) it returns the sum over chunks
    c0 ≤ i < c1 alone, each chunk's feedback taken from ``chain[i]``; the
    ranges' partials add up to the whole run."""
    _check_variant(variant)
    c0, c1 = (0, n_chunk) if chunk_range is None else chunk_range
    if chain is None and c0 > 0:
        raise ValueError("a range that starts after chunk 0 needs the feedback chain")
    if not 0 <= c0 <= c1 <= n_chunk:
        raise ValueError(f"chunk range {chunk_range} outside 0..{n_chunk}")
    acc = torch.zeros_like(s)
    ones = torch.ones_like(s)
    for i in range(c0, c1):
        feedback = acc[:, :1] if chain is None else chain[i][:, None]
        alpha = torch.clamp_max(torch.exp(s + feedback * 1e-6), 0.99)
        if variant == "exp_only":
            acc = acc + alpha
            continue
        if variant in ("log_tri", "log_tri_hs"):
            log1m = torch.log1p(-alpha)
            if tf32 and variant == "log_tri":
                log1m = round_to_tf32(log1m)
            cum = torch.cumsum(log1m, dim=1) - log1m  # exclusive, as log1m @ tri
            t_before = torch.exp(cum)
        elif variant == "roll_sub":
            incl = torch.cumprod(1.0 - alpha, dim=0)
            t_before = torch.cat([ones[:1], incl[:-1]], dim=0)
        else:  # roll_lane, seq_march
            incl = torch.cumprod(1.0 - alpha, dim=1)
            t_before = torch.cat([ones[:, :1], incl[:, :-1]], dim=1)
        acc = acc + alpha * t_before
    return acc


class ScanKernel(_CudaKernel):
    """``csrc/scan_variants.cu``: the Pallas ``kernel`` of the JAX package's
    ``tools/bench_scan_variants.py``.  Launch counts are kept per variant
    index in ``launches_by_channels``."""

    name = "scan_variants"
    argtypes = [_INT, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _PTR]
    count_keys = tuple(range(len(VARIANTS)))

    def __init__(self):
        super().__init__()
        self.chain_launches = dict.fromkeys(VARIANTS, 0)  # the chain launched alone

    def reset_counts(self) -> None:
        super().reset_counts()
        self.chain_launches = dict.fromkeys(VARIANTS, 0)

    def library(self):
        lib = super().library()
        fn = lib.scan_variants_chain
        fn.restype = ctypes.c_int
        fn.argtypes = [_INT, _PTR, _PTR, _INT, _PTR]
        lib.scan_variants_grid.restype = ctypes.c_int
        lib.scan_variants_grid.argtypes = [_INT, _INT]
        return lib

    def grid_blocks(self, variant: str, n_chunk: int = N_CHUNK) -> int:
        """Thread blocks of the variant's work launch at ``n_chunk`` chunks,
        from the grid the built library launches."""
        _check_variant(variant)
        blocks = self.library().scan_variants_grid(VARIANTS.index(variant), int(n_chunk))
        if blocks < 0:
            raise ValueError(f"{self.name}: no work grid for {variant} at {n_chunk} chunks")
        return blocks

    def _checked(self, s: torch.Tensor, variant: str, n_chunk: int) -> int:
        _check_variant(variant)
        self._check({"s": s}, {}, s.device)
        if tuple(s.shape) != (P, K):
            raise ValueError(f"{self.name} kernel: s shape {tuple(s.shape)}, needs {(P, K)}")
        if n_chunk < 0:
            raise ValueError(f"{self.name} kernel: n_chunk {n_chunk} < 0")
        return VARIANTS.index(variant)

    def __call__(self, s: torch.Tensor, variant: str, n_chunk: int = N_CHUNK) -> torch.Tensor:
        """Launch one variant on a (256, 256) fp32 CUDA block; returns acc.
        The chain table and the partials are scratch of this call."""
        v = self._checked(s, variant, int(n_chunk))
        n_range = n_ranges(n_chunk)
        chain = torch.empty((n_chunk, P), dtype=torch.float32, device=s.device)
        partial = torch.empty((n_range, P, K), dtype=torch.float32, device=s.device)
        out = torch.empty_like(s)
        self._launch(v, 1, s.device, s.data_ptr(), out.data_ptr(), chain.data_ptr(),
                     partial.data_ptr(), int(n_chunk), n_range)
        return out

    def chain(self, s: torch.Tensor, variant: str, n_chunk: int = N_CHUNK) -> torch.Tensor:
        """The chain launch alone: the (n_chunk, 256) feedback table, counted
        in ``chain_launches``, not in the variant's launches."""
        self._checked(s, variant, int(n_chunk))
        lib = self.library()
        chain = torch.empty((n_chunk, P), dtype=torch.float32, device=s.device)
        with torch.cuda.device(s.device):
            stream = torch.cuda.current_stream(s.device).cuda_stream
            err = lib.scan_variants_chain(VARIANTS.index(variant), s.data_ptr(),
                                          chain.data_ptr(), int(n_chunk), stream)
        if err != 0:
            raise RuntimeError(f"{self.name} chain launch failed: cudaError {err}")
        self.chain_launches[variant] += 1
        return chain

    def launches_of(self, variant: str) -> int:
        return self.launches_by_channels[VARIANTS.index(variant)]


SCAN = ScanKernel()


def scan_variants(s: torch.Tensor, variant: str, n_chunk: int = N_CHUNK) -> torch.Tensor:
    """The scan loop: the kernel for a CUDA tensor, the plain version for a
    CPU tensor."""
    if s.device.type == "cpu":
        return scan_variants_plain(s, variant, n_chunk)
    return SCAN(s, variant, n_chunk)


def seeded_block(device) -> torch.Tensor:
    """The tool's input: uniform(-8, -0.5) from numpy seed 0, as in the JAX tool."""
    s = np.random.default_rng(0).uniform(-8, -0.5, (P, K)).astype(np.float32)
    return torch.from_numpy(s).to(device)


def bound_us(variant: str) -> float:
    """Least µs per chunk the whole card could take for the operations the
    variant's function needs (``OPS``) at the fp32 peak rate.  The block
    never leaves the chip, so bytes bound nothing."""
    special, fp32 = OPS[variant]
    return P * K * (special * SFU_OPS + fp32) / PEAK_FP32_PER_S * 1e6


def latency_floor_us() -> tuple[float, float]:
    """The estimated (low, high) µs per chunk of the row variants' feedback
    chain that ties chunk i to chunk i − 1 (``CHAIN_CYCLES`` at
    ``BOOST_CLOCK_HZ``): an estimate from the chain's instructions, not a
    measurement (:func:`chain_us` measures it)."""
    return tuple(c / BOOST_CLOCK_HZ * 1e6 for c in CHAIN_CYCLES)


def _cuda_block(device) -> torch.Tensor:
    """The seeded block on ``device``, which must be a CUDA device."""
    if torch.device(device).type != "cuda":
        raise ValueError("the scan benchmark times the CUDA kernel; it needs a CUDA device")
    return seeded_block(device)


def _median_us_per_chunk(fn, n_chunk: int, device, calls: int = 10
                         ) -> tuple[float, torch.Tensor]:
    """(µs per chunk, last result) of ``fn()``: CUDA events around ``calls``
    calls in a row, median of 5 such windows after a warm-up.  A call is
    ≈ 0.1 ms on the card, so a single call's window would also hold the
    host's allocations and launch ahead of it; in a row the host runs ahead
    of the card."""
    out = fn()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            out = fn()
        end.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times)) * 1e3 / max(n_chunk, 1), out


def run(variant: str, n_chunk: int = N_CHUNK, device="cuda") -> tuple[float, torch.Tensor]:
    """(µs per chunk, acc) of the whole call (chain, work and sum)."""
    s = _cuda_block(device)
    return _median_us_per_chunk(lambda: SCAN(s, variant, n_chunk), n_chunk, device)


def chain_us(variant: str, n_chunk: int = N_CHUNK, device="cuda") -> float:
    """µs per chunk of the variant's chain launch alone: the measured floor
    every call of the variant pays before its work."""
    s = _cuda_block(device)
    return _median_us_per_chunk(lambda: SCAN.chain(s, variant, n_chunk), n_chunk, device)[0]


def cumprod_library_us(device="cuda", dim: int = 1, iters: int = 200) -> float:
    """µs of one ``torch.cumprod`` over the (256, 256) block along ``dim``:
    the one PyTorch call that computes T_before.  A yardstick only; nothing
    calls it."""
    x = 1.0 - torch.clamp_max(torch.exp(seeded_block(device)), 0.99)
    for _ in range(10):
        torch.cumprod(x, dim=dim)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        torch.cumprod(x, dim=dim)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / iters


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n_chunk", type=int, default=N_CHUNK)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available: the scan benchmark runs on the card")
    print(torch.cuda.get_device_name(torch.device(args.device)))
    low, high = latency_floor_us()
    floors = {kind: chain_us(kind, args.n_chunk, args.device) for kind in ("roll_lane", "roll_sub")}
    print(f"feedback chain, launched alone: {floors['roll_lane']:.4f} us/chunk (row variants; "
          f"estimate {low:.3f}-{high:.3f}), {floors['roll_sub']:.4f} us/chunk (roll_sub's "
          f"column-0 scan)")
    for v in VARIANTS:
        us, _ = run(v, args.n_chunk, args.device)
        floor = max(bound_us(v), floors["roll_sub" if v in SCAN_CHAIN else "roll_lane"])
        print(f"{v:12s} {us:8.3f} us/chunk  ({P}x{K})  bound {bound_us(v):.4f} us on the card, "
              f"{floor / us:.0%} of max(bound, chain); {SCAN.grid_blocks(v, args.n_chunk)} blocks",
              flush=True)
    print(f"{'torch.cumprod':12s} {cumprod_library_us(args.device):8.3f} us/call   ({P}x{K})")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
