"""Training reporting.

Counterpart of ``seganygaussians_tpu/utils/reporting.py``: a
``TrainingReporter`` that always appends to ``<model_path>/metrics.jsonl`` and
mirrors scalars and histograms to TensorBoard when
``torch.utils.tensorboard`` imports (the model path is the log directory).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


class TrainingReporter:
    def __init__(self, model_path: str, enable_tensorboard: bool = True):
        self.model_path = model_path
        os.makedirs(model_path, exist_ok=True)
        self._jsonl = open(os.path.join(model_path, "metrics.jsonl"), "a")
        self._t0 = time.time()
        self._tb = None
        if enable_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None  # TensorBoard is optional
            if SummaryWriter is not None:
                self._tb = SummaryWriter(model_path)

    def scalars(self, iteration: int, tag_values: dict, prefix: str = ""):
        rec = {"iter": int(iteration), "t": round(time.time() - self._t0, 3)}
        for k, v in tag_values.items():
            rec[prefix + k] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(prefix + k, float(v), iteration)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def histogram(self, iteration: int, tag: str, values: np.ndarray):
        if self._tb is not None:
            self._tb.add_histogram(tag, np.asarray(values), iteration)

    def eval_report(self, iteration: int, split: str, l1: float, psnr: float):
        print(f"[ITER {iteration}] {split}: L1 {l1:.5f} PSNR {psnr:.2f}", flush=True)
        self.scalars(iteration, {f"{split}/l1": l1, f"{split}/psnr": psnr})

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
