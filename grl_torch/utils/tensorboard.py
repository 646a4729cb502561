"""Scalar/histogram logging: JSONL always, TensorBoard when available.

A copy of ``grl_tpu/utils/tensorboard.py`` (pure Python).

Replaces the reference's tensorboardX SummaryWriter + Neptune dual logging
(reference: gnn/trainer/training_procedures/base_procedure.py:44-47,
gnn/utils/constant.py:5-8). JSONL is the source of truth (greppable,
dependency-free); a TensorBoard writer attaches opportunistically.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsWriter:
    def __init__(self, log_dir: str, enable_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a", encoding="utf-8")
        self._tb = None
        if enable_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None
        self._last_step_time: Optional[float] = None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        record = {"tag": tag, "value": float(value), "step": int(step), "ts": time.time()}
        self._jsonl.write(json.dumps(record) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def add_scalars(self, values: Dict[str, float], step: int, prefix: str = "") -> None:
        for tag, value in values.items():
            self.add_scalar(f"{prefix}{tag}", value, step)

    def add_histogram(self, tag: str, values: Any, step: int) -> None:
        if self._tb is not None:
            self._tb.add_histogram(tag, values, step)

    def steps_per_sec(self) -> Optional[float]:
        now = time.time()
        rate = None
        if self._last_step_time is not None:
            delta = now - self._last_step_time
            rate = 1.0 / delta if delta > 0 else None
        self._last_step_time = now
        return rate

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class NullWriter(MetricsWriter):
    """A writer that writes nothing: the ranks after the first of a world,
    whose summaries the first rank's writer already holds."""

    def __init__(self):
        self._tb = None
        self._last_step_time = None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass
