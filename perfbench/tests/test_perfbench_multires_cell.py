"""The committed cell ``m360_garden_multires.feature_train`` on the CPU.

Its configuration, limits and entries in ``BENCHMARK.json`` are the
repository's own (only the sizes are cut to a CPU's, as ``_tiny_copy``
does): a run reads ``correct``; a traced run finds a reader file for every
per-layer metric listed for the cell, and the program's level spans and row
counters are in its window, while the two readers of device time per row
and of the finest level give nothing without a card.
"""

from __future__ import annotations

import json

from perfbench import harness
from perfbench.tests.test_perfbench_imports import _tiny_copy, run_cell

CELL = "m360_garden_multires.feature_train"
SEED = 2718281828459
READERS = ("smooth_row_ns.multires", "smooth_fine_ms.multires")


def test_committed_cell_is_correct(tmp_path):
    root = _tiny_copy(tmp_path)
    cfg = json.loads((root / "perfbench/configs/m360_garden_multires.json").read_text())
    assert cfg["feature"]["smooth_type"] == "multi_res"
    rc, result = run_cell(root, CELL, seed=SEED, seconds=1.0)
    assert rc == 0 and result["correct"] is True
    assert set(result["checks"]) == {"loss1_gap", "grad_gap", "change_gap", "map_faults",
                                     "knn_miss"}
    assert set(result["metrics"]) == {"feature_step_ms", "setup_s"}


def test_traced_cell_reads_every_listed_metric_file(tmp_path):
    from seganygaussians_torch.utils import tracing

    root = _tiny_copy(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    listed = [m["name"] for m in harness.metrics_of(bench, CELL, True)]
    assert set(READERS) <= set(listed) and len(listed) == 7
    for name in listed:
        assert harness.metric_file(root, name).is_file(), name
    rc, result = run_cell(root, CELL, seed=SEED, seconds=1.0, trace=1)
    assert rc == 0 and result["correct"] is True
    assert set(result["metrics"]) <= set(listed)
    assert "host_syncs.multires" in result["metrics"]
    # The window holds the level spans and the row counters; on the CPU the
    # spans have no device time, so the two readers give nothing.
    s = tracing.summary()
    n = json.loads((root / "perfbench/configs/m360_garden_multires.json").read_text())[
        "num_gaussians"]
    steps = s["spans"]["feature_step"]["count"]
    assert s["counters"]["smoothing.rows"] == steps * n * (4 + 4 + 16)
    assert s["counters"]["smoothing.rows.level2"] == steps * n * 16
    assert all(s["spans"][f"smoothing.level{i}"]["device_ms"] is None for i in range(3))
    assert not set(READERS) & set(result["metrics"])
