"""Profiling: ``torch.profiler`` traces of a window of training steps.

Counterpart of ``grl_tpu/utils/profiling.py``'s :class:`Profiler`, with
``torch.profiler`` in place of ``jax.profiler``. Traces are Chrome-trace
JSON files (``chrome://tracing``, Perfetto) under ``<output_dir>/traces``;
the device's kernels are in them when a GPU is visible.
"""
from __future__ import annotations

import os
from typing import Optional

import torch


def _activities():
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return activities


class Profiler:
    """Config-driven trainer hook: trace steps [start, stop) of training.

    Config block::

        logging:
          profile: {start_step: 10, num_steps: 5}

    The trace lands in ``<log_dir>/traces/steps_<start>_<stop>.json``.
    """

    def __init__(self, log_dir: str, start_step: int = -1, num_steps: int = 0):
        self.log_dir = os.path.join(log_dir, "traces")
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self._prof: Optional[torch.profiler.profile] = None

    def maybe_start(self, step: int) -> None:
        if self.start_step >= 0 and step == self.start_step and self._prof is None:
            os.makedirs(self.log_dir, exist_ok=True)
            self._prof = torch.profiler.profile(activities=_activities())
            self._prof.start()

    def maybe_stop(self, step: int) -> Optional[str]:
        if self._prof is not None and step >= self.stop_step:
            self._prof.stop()
            path = os.path.join(self.log_dir, f"steps_{self.start_step}_{self.stop_step}.json")
            self._prof.export_chrome_trace(path)
            self._prof = None
            return path
        return None
