"""The port imports nothing of JAX and nothing of the JAX package."""

import os
import pkgutil
import subprocess
import sys

import seganygaussians_torch

ROOT = os.path.join(os.path.dirname(__file__), "..")

_CHECK = """
import importlib, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "seganygaussians_tpu", "tools"))
assert not bad, bad
print(len(sys.argv) - 1)
"""


def test_port_imports_no_jax():
    names = ["seganygaussians_torch"] + [
        m.name
        for m in pkgutil.walk_packages(seganygaussians_torch.__path__, "seganygaussians_torch.")
    ]
    assert "seganygaussians_torch.ops.blend_cuda" in names
    assert "seganygaussians_torch.cli.render" in names
    assert "seganygaussians_torch.train.scene_trainer" in names
    assert "seganygaussians_torch.cli.train_scene" in names
    for module in ("ops.quantile", "seg.scale_gate", "models.feature_gaussians", "preprocess",
                   "train.contrastive_trainer", "cli.get_scale",
                   "cli.train_contrastive_feature", "tools.bench_scan_variants",
                   "utils.precision", "seg.queries", "seg.clustering", "seg.clip_text",
                   "seg.language", "seg.clip_image", "cli.prompt_segment",
                   "cli.get_clip_features", "cli.extract_segment_everything_masks",
                   "viewer", "viewer.interactive", "viewer.network_gui", "viewer.web_gui",
                   "cli.gui", "parallel", "parallel.mesh", "parallel.data_parallel",
                   "parallel.contrastive_dp", "parallel.tile_sharded", "parallel.dryrun",
                   "utils.lpips_metric", "cli.convert"):
        assert f"seganygaussians_torch.{module}" in names, module
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.path.abspath(ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", _CHECK, *names],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) == len(names) >= 57


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py imports nothing of JAX either; on a machine without CUDA
    it exits non-zero before printing a result."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run(
        [sys.executable, "-c",
         "import runpy, sys\n"
         "try:\n    runpy.run_path('chip_smoke.py', run_name='__main__')\n"
         "except SystemExit as e:\n    code = e.code\nelse:\n    code = 0\n"
         "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'seganygaussians_tpu'))\n"
         "assert not bad, bad\nsys.exit(code)"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
