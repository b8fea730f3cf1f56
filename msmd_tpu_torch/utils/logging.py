"""Metric logging (the port of ``msmd_tpu/utils/logging.py``): TensorBoard
when a writer package is installed (the reference logs through
tensorboardX, training_script.py:13,563), and always a JSONL file."""

from __future__ import annotations

import importlib
import json
import time
from pathlib import Path


class MetricWriter:
    def __init__(self, log_dir):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._tb = None
        for mod in ("tensorboardX", "torch.utils.tensorboard"):
            try:
                self._tb = importlib.import_module(mod).SummaryWriter(str(self.log_dir))
                break
            except Exception:
                continue
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")

    def scalar(self, tag: str, value: float, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": int(step), "ts": time.time()}) + "\n")
        self._jsonl.flush()

    def scalars(self, prefix: str, values: dict, step: int):
        for k, v in values.items():
            self.scalar(f"{prefix}/{k}", v, step)

    def close(self):
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()
