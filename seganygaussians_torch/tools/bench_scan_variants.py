"""Micro-benchmark of transmittance-scan strategies for the blend kernels:
which way of computing a cumulative product along the instance axis is
fastest on this card?

    python -m seganygaussians_torch.tools.bench_scan_variants

Counterpart of ``tools/bench_scan_variants.py`` of the JAX package.  All
variants loop ``n_chunk`` times over a (256, 256) fp32 block that stays in
registers and shared memory (pure compute, no device-memory traffic), in the
hand-written kernel ``csrc/scan_variants.cu``:

  exp_only    floor: alpha = min(0.99, exp(s)) and a sum (no scan)
  log_tri     log1p → strict-upper-triangular product on the tensor cores
              (TF32, fp32 accumulate) → exp
  log_tri_hs  the same product as IEEE fp32 multiply-adds
  roll_lane   Hillis-Steele product scan along K: warp shuffles, carry across
              warps through shared memory
  roll_sub    the same scan along axis 0, stride-doubling passes through
              shared memory
  seq_march   one thread per row marching K in order (the inner loop of
              ``csrc/blend_fwd.cu``); computes roll_lane's function

``scan_variants_plain`` is the same loop in plain PyTorch for the tests and
the comparison on the card; the tool's timing never uses it.

Two floors stand beside each time.  ``bound_us`` counts the operations of the
function, the same for every variant that computes T_before, at the card's
peak rates.  ``latency_floor_us`` is an estimate, not a measurement: chunk
i's ``exp`` waits on chunk i − 1's ``acc[:, 0]`` (the feedback term), so the
chunks form one dependent chain of about 40-60 cycles (multiply, add,
``expf``, ``fminf``, the accumulate, and the hand-over of ``acc[:, 0]``)
that no design can overlap; at the H100's 1.98 GHz boost clock that is
0.020-0.030 µs a chunk, 5-8 times ``bound_us``.
"""

from __future__ import annotations

import numpy as np
import torch

from seganygaussians_torch.ops.blend_cuda import _INT, _PTR, _CudaKernel

P, K, N_CHUNK = 256, 256, 1000
VARIANTS = ("exp_only", "log_tri", "log_tri_hs", "roll_lane", "roll_sub", "seq_march")

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor cores
# 67 TFLOP/s, over 132 SMs.
PEAK_FP32_PER_S = 67e12
NUM_SMS = 132
# Thread blocks each variant's grid launches (csrc/scan_variants.cu).
GRID_BLOCKS = {"exp_only": 256, "log_tri": 16, "log_tri_hs": 256, "roll_lane": 256,
               "roll_sub": 32, "seq_march": 8}
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


def round_to_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 → TF32 (10 mantissa bits), round to nearest, ties away from zero:
    what ``cvt.rna.tf32.f32`` does to the tensor cores' inputs."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def scan_variants_plain(s: torch.Tensor, variant: str, n_chunk: int,
                        tf32: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device.

    ``tf32=True`` rounds log_tri's ``log1p(-alpha)`` to TF32 before the sum,
    as the kernel's tensor-core product does."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; choose from {VARIANTS}")
    acc = torch.zeros_like(s)
    ones = torch.ones_like(s)
    for _ in range(n_chunk):
        alpha = torch.clamp_max(torch.exp(s + acc[:, :1] * 1e-6), 0.99)
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
    argtypes = [_INT, _PTR, _PTR, _INT, _PTR]
    count_keys = tuple(range(len(VARIANTS)))

    def __call__(self, s: torch.Tensor, variant: str, n_chunk: int = N_CHUNK) -> torch.Tensor:
        """Launch one variant on a (256, 256) fp32 CUDA block; returns acc."""
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}; choose from {VARIANTS}")
        self._check({"s": s}, {}, s.device)
        if tuple(s.shape) != (P, K):
            raise ValueError(f"{self.name} kernel: s shape {tuple(s.shape)}, needs {(P, K)}")
        out = torch.empty_like(s)
        self._launch(VARIANTS.index(variant), 1, s.device, s.data_ptr(), out.data_ptr(),
                     int(n_chunk))
        return out

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
    """The estimated (low, high) µs per chunk of the feedback chain that ties
    chunk i to chunk i − 1 (``CHAIN_CYCLES`` at ``BOOST_CLOCK_HZ``): an
    estimate from the chain's instructions, not a measurement, and the same
    for every variant."""
    return tuple(c / BOOST_CLOCK_HZ * 1e6 for c in CHAIN_CYCLES)


def bound_us_on_grid_sms(variant: str) -> tuple[float, int]:
    """:func:`bound_us` scaled to the SMs the variant's grid can occupy, and
    that number of SMs: what the kernel's own launch shape allows it, beside
    the card's bound.  The gap between the two is the grid's under-occupancy,
    which belongs to the kernel, not to the bound."""
    sms = min(GRID_BLOCKS[variant], NUM_SMS)
    return bound_us(variant) * NUM_SMS / sms, sms


def run(variant: str, n_chunk: int = N_CHUNK, device="cuda") -> tuple[float, torch.Tensor]:
    """(µs per chunk, acc): median of 5 launches after a warm-up, CUDA events."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the scan benchmark times the CUDA kernel; it needs a CUDA device")
    s = seeded_block(device)
    out = SCAN(s, variant, n_chunk)
    torch.cuda.synchronize(device)
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = SCAN(s, variant, n_chunk)
        end.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(end))
    return float(np.median(times)) * 1e3 / n_chunk, out


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
    print(f"feedback chain between chunks: {low:.3f}-{high:.3f} us/chunk (an estimate from "
          f"its instructions, not a measurement)")
    for v in VARIANTS:
        us, _ = run(v, args.n_chunk, args.device)
        grid_us, sms = bound_us_on_grid_sms(v)
        print(f"{v:12s} {us:8.3f} us/chunk  ({P}x{K})  bound {bound_us(v):.4f} us on the card "
              f"({grid_us:.4f} us on the grid's {sms} SMs)", flush=True)
    print(f"{'torch.cumprod':12s} {cumprod_library_us(args.device):8.3f} us/call   ({P}x{K})")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
