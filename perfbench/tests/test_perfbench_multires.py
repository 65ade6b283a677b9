"""SAGA's multi-resolution feature field as a configuration of new files only.

A tiny configuration with ``feature.smooth_type = "multi_res"`` (SAGA's three
levels: sample rates 0.1, 0.5 and 1.5 with K = 4, 4 and 16) is added to a
checkout of the benchmark, with a ``feature_train`` and a ``segment`` cell.
The feature runner, its reference and its neighbour checks follow the
smoothing: a sound run is correct; a step that returns its state unchanged,
half of the rays left out, or one level's map with a column taken from the
next row's list is not.  ``segment`` refuses the configuration: the session
smooths over the K-neighbour map only.
"""

from __future__ import annotations

import json

import pytest
import torch

from perfbench.tests.test_perfbench_faults import _failed
from perfbench.tests.test_perfbench_imports import BENCH, _tiny_copy, run_cell

CONFIG = "tiny_multires"
LEVELS = {"sample_rates": [0.1, 0.5, 1.5], "ks": [4, 4, 16]}
SEED = 987654321098


def _add_multires(root):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "perfbench/configs/m360_garden.json").read_text())
    cfg["name"] = CONFIG
    cfg["feature"].update(smooth_type="multi_res", multi_res=LEVELS)
    (root / f"perfbench/configs/{CONFIG}.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": CONFIG, "source": "https://example.org/multires",
                             "file": f"perfbench/configs/{CONFIG}.json", "reduced": [],
                             "why": "test"})
    for traffic, metric in (("feature_train", "feature_step_ms"), ("segment", "request_ms_p95")):
        cell = f"{CONFIG}.{traffic}"
        bench["workloads"].append({"name": cell, "config": CONFIG, "traffic": traffic,
                                   "chips": 1, "why": "test"})
        next(m for m in bench["end_to_end"] if m["name"] == metric)["workloads"].append(cell)
        limits = root / f"perfbench/limits/m360_garden.{traffic}.json"
        (root / f"perfbench/limits/{cell}.json").write_text(limits.read_text())
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _bench_files():
    return {p: p.read_bytes() for p in BENCH.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _add_multires(_tiny_copy(tmp_path_factory.mktemp("multires")))


def _run(root):
    rc, result = run_cell(root, f"{CONFIG}.feature_train", seed=SEED, seconds=1.0)
    assert rc == 0
    return result


def test_feature_train_is_correct_from_new_files_only(root):
    before = _bench_files()
    result = _run(root)
    assert result["correct"] is True
    assert set(result["checks"]) == {"loss1_gap", "grad_gap", "change_gap", "map_faults",
                                     "knn_miss"}
    assert set(result["metrics"]) == {"feature_step_ms", "setup_s"}
    assert before == _bench_files()


def test_feature_train_faults(root, monkeypatch):
    from seganygaussians_torch.models import feature_gaussians as fgm
    from seganygaussians_torch.train import contrastive_trainer as ct

    real = ct.contrastive_step

    def unchanged(feat_state, gate_params, gate_opt, *args, **kw):
        return (feat_state, gate_params, gate_opt) + tuple(
            real(feat_state, gate_params, gate_opt, *args, **kw)[3:])

    with monkeypatch.context() as m:
        m.setattr(ct, "contrastive_step", unchanged)
        assert not _run(root)["correct"]
    draw = ct.draw_step

    def half_rays(*args, **kw):
        d = draw(*args, **kw)
        r = d.ray_idx.shape[0] // 2
        return d._replace(ray_idx=d.ray_idx[:r], pair_rand=d.pair_rand[:r, :r])

    with monkeypatch.context() as m:
        m.setattr(ct, "draw_step", half_rays)
        assert not _run(root)["correct"]
    knn, calls = fgm.knn_query_source, []

    def rolled_first_level(query, source, k, *args, **kw):
        idx = knn(query, source, k, *args, **kw)
        calls.append(k)
        if len(calls) == 1:  # the coarsest level: one column from the next row's list
            idx[:, k // 2] = torch.roll(idx[:, k // 2], 1)
        return idx

    with monkeypatch.context() as m:
        m.setattr(fgm, "knn_query_source", rolled_first_level)
        result = _run(root)
    assert calls == LEVELS["ks"]
    assert not result["correct"] and "knn_miss" in _failed(result)


def test_segment_refuses_multi_res(root, capsys):
    rc, result = run_cell(root, f"{CONFIG}.segment", seed=SEED, seconds=1.0)
    assert rc != 0 and result is None
    assert "smooth_type is 'multi_res'" in capsys.readouterr().err
