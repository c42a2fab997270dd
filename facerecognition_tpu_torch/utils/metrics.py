"""Metrics logging: a JSONL stream, and TensorBoard when asked for.

Counterpart of ``facerecognition_tpu/utils/metrics.py``: the always-on sink
is an append-only ``metrics.jsonl``; TensorBoard is opt-in through
``FRT_TENSORBOARD=1`` and imported only then.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional


class MetricsLogger:
    def __init__(self, directory: str, enable_tensorboard: Optional[bool] = None):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, "metrics.jsonl")
        self._tb = None
        if enable_tensorboard is None:
            enable_tensorboard = os.environ.get("FRT_TENSORBOARD") == "1"
        if enable_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(directory, "tb"))
            except ImportError:
                self._tb = None

    def log(self, step: int, metrics: dict[str, Any], prefix: str = "") -> None:
        record = {"step": step, "time": time.time(), **metrics}
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=float) + "\n")
        if self._tb is not None:
            for k, v in metrics.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(f"{prefix}{k}", v, step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
