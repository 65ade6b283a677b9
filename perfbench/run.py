#!/usr/bin/env python3
"""Run one benchmark cell of seganygaussians_torch once, on the machine it is
started on, and print its result as the last line of standard output.

    python3 perfbench/run.py --workload m360_garden.scene_train --seed 7 \\
        --seconds 30 --trace 0

Run from the root of a checkout.  The cell, its configuration and its
traffic mix are found by name through ``BENCHMARK.json``; see
``perfbench/harness.py``.
"""

import time

PROCESS_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# Build and kernel caches live at fixed paths inside the checkout, so that
# only a checkout's first run builds.
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], root=ROOT, started=PROCESS_START))
