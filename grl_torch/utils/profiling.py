"""Profiling: ``torch.profiler`` traces and throughput counters.

Counterpart of ``grl_tpu/utils/profiling.py``, with ``torch.profiler`` in
place of ``jax.profiler``: :func:`trace_window` traces a block,
:class:`Profiler` a window of training steps, and :class:`StepTimer`
keeps steps/s and other rates. Traces are Chrome-trace JSON files
(``chrome://tracing``, Perfetto); the device's kernels are in them when a
GPU is visible.

:func:`span` names the host work of the training loop (a chunk's load,
replay and read-back, an eager step, the per-step scoring and logging) in
whatever ``torch.profiler`` session is active, so that each idle gap of the
device on a trace's timeline lies inside the host work that caused it.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch


_NO_SPAN = contextlib.nullcontext()


def span(name: Optional[str]):
    """A named range of host work while a ``torch.profiler`` session is
    active, else (or where ``name`` is ``None``) one shared null context
    that records, reads and allocates nothing.

    The range is ``torch._C._profiler._RecordFunctionFast``: a ``cpu_op``
    event on the same clock as the device's kernels and copies, entered in
    C++. ``torch.profiler.record_function`` dispatches two profiler ops a
    range and, over a chunk's 16 spans, slowed a traced KV training window
    on an H100 by 7–9%, against 2–3% for this one.

    Only around host work between chunks and steps: never inside a body
    that :class:`~grl_torch.trainer.captured.CapturedSteps` captures, since
    a range recorded at capture is not replayed."""
    if name is not None and torch.autograd._profiler_enabled():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN


def _activities():
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return activities


@contextlib.contextmanager
def trace_window(log_dir: str, enabled: bool = True) -> Iterator[Optional[str]]:
    """Trace the block with ``torch.profiler`` into a Chrome trace under
    ``log_dir`` (``trace_<n>.json``, ``n`` counting the traces already
    there); yields the trace's path, or ``None`` when not ``enabled``."""
    if not enabled:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    index = sum(name.startswith("trace_") for name in os.listdir(log_dir))
    path = os.path.join(log_dir, f"trace_{index}.json")
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    try:
        yield path
    finally:
        prof.stop()
        prof.export_chrome_trace(path)


class StepTimer:
    """Rolling throughput counters for training loops (``profiling.py:33-56``)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._start = time.perf_counter()
        self._steps = 0
        self._units: Dict[str, float] = {}

    def step(self, **units: float) -> None:
        """Record one step and any unit counts (nodes=..., edges=...)."""
        self._steps += 1
        for key, value in units.items():
            self._units[key] = self._units.get(key, 0.0) + value

    def rates(self) -> Dict[str, float]:
        elapsed = max(time.perf_counter() - self._start, 1e-9)
        out = {"steps_per_sec": self._steps / elapsed}
        for key, value in self._units.items():
            out[f"{key}_per_sec"] = value / elapsed
        return out


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
