"""Times two builds of the scan kernel side by side on one card: this
checkout's ``csrc/scan_variants.cu`` and another source of it, such as the
parent commit's, each with one call and with 10 calls a timing window.

    git archive <commit> seganygaussians_torch/csrc | tar -x -C build/other
    python -m seganygaussians_torch.tools.compare_scan_kernels \\
        --other build/other/seganygaussians_torch/csrc/scan_variants.cu \\
        --out build/scan_compare.json

The other source may have this one's C interface or the single-launch one
that came before the chain design, ``scan_variants_launch(variant, s, out,
n_chunk, stream)``.  Each variant runs in the order other, this, this,
other, with the same window (``bench_scan_variants._median_us_per_chunk``),
so a difference between the two is not one of the timing's.  Both outputs
are held against ``scan_variants_plain`` to 1e-4 relative.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from seganygaussians_torch.ops.blend_cuda import _INT, _PTR
from seganygaussians_torch.tools import bench_scan_variants as tool

TOL = 1e-4  # relative, as the tool's tests hold the kernel


def other_kernel(source: Path):
    """fn(s, variant, n_chunk) -> acc: ``source`` built with this one's flags
    into its own library (its digest names it), called through its C
    interface."""
    kernel = tool.ScanKernel()
    kernel.source = Path(source).resolve()
    lib = ctypes.CDLL(str(kernel.build()))
    if hasattr(lib, "scan_variants_chain"):  # this one's interface
        return kernel
    launch = lib.scan_variants_launch  # one launch, no scratch
    launch.restype = ctypes.c_int
    launch.argtypes = [_INT, _PTR, _PTR, _INT, _PTR]

    def call(s, variant, n_chunk):
        out = torch.empty_like(s)
        stream = torch.cuda.current_stream(s.device).cuda_stream
        err = launch(tool.VARIANTS.index(variant), s.data_ptr(), out.data_ptr(), n_chunk, stream)
        if err != 0:
            raise RuntimeError(f"{source}: cudaError {err}")
        return out
    return call


def _relative(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())


def compare(other: Path, n_chunk: int = tool.N_CHUNK, device="cuda") -> dict:
    """Per variant and window size (1 and 10 calls): the other source's two
    readings and this one's two, µs per chunk, in the order taken."""
    if torch.device(device).type != "cuda":
        raise ValueError("the comparison times CUDA kernels; it needs a CUDA device")
    s = tool.seeded_block(device)
    theirs = other_kernel(other)
    ours = tool.SCAN
    result = {"n_chunk": n_chunk, "other": str(other), "variants": {}}
    for v in tool.VARIANTS:
        plain = tool.scan_variants_plain(s, v, n_chunk, tf32=True)
        row = {}
        for calls in (1, 10):
            fns = {"other": lambda: theirs(s, v, n_chunk), "this": lambda: ours(s, v, n_chunk)}
            readings = {"other": [], "this": []}
            for who in ("other", "this", "this", "other"):
                us, out = tool._median_us_per_chunk(fns[who], n_chunk, device, calls)
                rel = _relative(out, plain)
                if rel > TOL:
                    raise AssertionError(f"{who} {v}: {rel:.3g} relative to plain (> {TOL})")
                readings[who].append(us)
            row[f"calls_{calls}"] = readings
        result["variants"][v] = row
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", type=Path, required=True, help="another scan_variants.cu")
    parser.add_argument("--n_chunk", type=int, default=tool.N_CHUNK)
    parser.add_argument("--out", type=Path, default=None, help="JSON of every reading")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available: the comparison runs on the card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True
                          ).stdout.strip().splitlines()[0]
    result = compare(args.other, args.n_chunk)
    result["card"] = card
    print(f"us per chunk at {args.n_chunk} chunks, readings in the order other, this, this, "
          f"other  [{card}]")
    for v, row in result["variants"].items():
        for calls in (1, 10):
            r = row[f"calls_{calls}"]
            print(f"{v:11s} {calls:2d} call(s) a window: other {np.median(r['other']):.4f} "
                  f"this {np.median(r['this']):.4f}  ({', '.join(f'{x:.4f}' for x in r['other'])}"
                  f" | {', '.join(f'{x:.4f}' for x in r['this'])})")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
