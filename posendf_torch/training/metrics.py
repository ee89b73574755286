"""Training metrics: running averages and a JSON-lines event log.

Port of ``posendf_tpu/training/metrics.py``: the reference's AverageMeter
aggregation (``model/loss_utils.py:4-22``) and a ``metrics.jsonl`` log, with
an optional TensorBoard mirror that is off when
``torch.utils.tensorboard`` cannot be imported.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

__all__ = ["RunningAverage", "MetricsLogger"]


class RunningAverage:
    """val/sum/count/avg running aggregate (the AverageMeter capability)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class MetricsLogger:
    """JSON-lines metrics sink + optional TensorBoard mirror."""

    def __init__(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, "metrics.jsonl")
        self._f = open(self.path, "a", buffering=1)
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # TensorBoard is optional
            SummaryWriter = None
        self._tb = None if SummaryWriter is None else SummaryWriter(
            os.path.join(directory, "summary"))
        self._t0 = time.time()

    def log(self, step: int, scalars: Dict[str, float], prefix: str = "train"):
        rec = {"step": step, "t": round(time.time() - self._t0, 3)}
        rec.update({f"{prefix}/{k}": float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(f"{prefix}/{k}", float(v), step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
