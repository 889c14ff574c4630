"""Metrics logging.

Port of ``surgical_tpu/utils/logging.py``: one logger that writes an
append-only JSONL stream (``metrics.jsonl``) and mirrors scalars to
TensorBoard when ``torch.utils.tensorboard`` is importable.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Mapping


class MetricsLogger:
    def __init__(self, directory: str, tensorboard: bool = True):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.jsonl_path = os.path.join(directory, "metrics.jsonl")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(directory, "tb"))
            except ImportError:
                self._tb = None

    def log(self, step: int, metrics: Mapping[str, Any], prefix: str = "") -> None:
        record = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            key = f"{prefix}{k}"
            try:
                record[key] = float(v)
            except (TypeError, ValueError):
                record[key] = v
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._tb is not None:
            for k, v in record.items():
                if k in ("step", "time") or not isinstance(v, float):
                    continue
                self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
