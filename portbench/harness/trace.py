"""The traced part of a ``--trace 1`` run, and what the readers get.

:class:`Tracer` opens a ``torch.profiler`` window at a boundary between
two chunks of work, once the window has run, and closes it at the first
boundary after ``seconds``, both after a synchronise, so that the trace
holds whole chunks and the counters taken at both ends count exactly the
work in it. The harness's own spans (:meth:`Tracer.span`) are kept in
memory, and marked in the trace. :func:`read_trace` reduces the Chrome
trace to device intervals inside the window; :func:`device_busy_us` is the
union of kernel, copy and memset intervals (``chip_smoke.py``'s
``device_idle_share``, copied).
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

WINDOW_SPAN = "portbench.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


class Tracer:
    def __init__(self, torch, enabled: bool, seconds: float):
        self.torch = torch
        self.seconds = seconds
        self.state = "waiting" if enabled else "off"
        self.profiler = None
        self.annotation = None
        self.start_counters: Dict[str, float] = {}
        self.end_counters: Dict[str, float] = {}
        self.t0 = 0.0
        self.spans: Dict[str, List[float]] = defaultdict(list)
        self.trace_path: Optional[str] = None

    @property
    def active(self) -> bool:
        return self.state == "tracing"

    def boundary(self, counters: Dict[str, float], closing: bool = False) -> None:
        """Called between two chunks, with the run's counters as they stand."""
        if self.state == "waiting" and not closing:
            torch = self.torch
            self._sync()
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.profiler = torch.profiler.profile(activities=activities)
            self.profiler.__enter__()
            self.annotation = torch.profiler.record_function(WINDOW_SPAN)
            self.annotation.__enter__()
            self.start_counters = dict(counters)
            self.t0 = time.perf_counter()
            self.state = "tracing"
        elif self.state == "tracing" and (closing or time.perf_counter() - self.t0 >= self.seconds):
            self._sync()
            self.end_counters = dict(counters)
            self.annotation.__exit__(None, None, None)
            self.profiler.__exit__(None, None, None)
            handle, self.trace_path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
            os.close(handle)
            self.profiler.export_chrome_trace(self.trace_path)
            self.profiler = None
            self.state = "done"

    def _sync(self) -> None:
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()

    @contextlib.contextmanager
    def span(self, name: str):
        """A span of the harness's own around a call into the program."""
        if not self.active:
            yield
            return
        start = time.perf_counter()
        with self.torch.profiler.record_function("portbench." + name):
            yield
        self.spans[name].append(time.perf_counter() - start)

    def counters(self) -> Dict[str, float]:
        """Each counter's change over the traced window."""
        return {k: self.end_counters.get(k, 0) - self.start_counters.get(k, 0)
                for k in set(self.start_counters) | set(self.end_counters)}


def read_trace(path: str):
    """``(device, host, spans, window_us)`` of a Chrome trace: the device
    events and the host events that lie in the traced window, each
    ``(name, start_us, end_us)`` clipped to it, the device seconds of each
    of the harness's spans (the profiler's ``gpu_user_annotation`` of a
    ``record_function``: from the first to the last device work launched
    inside it), and the window's length."""
    with open(path) as handle:
        events = [e for e in json.load(handle)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in events if e.get("name") == WINDOW_SPAN and e.get("cat") == "user_annotation"]
    lo = marks[0]["ts"] if marks else min(e["ts"] for e in events)
    hi = lo + marks[0]["dur"] if marks else max(e["ts"] + e["dur"] for e in events)
    device, host = [], []
    spans: Dict[str, float] = defaultdict(float)
    for e in events:
        start, end = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
        if end <= start:
            continue
        if e.get("cat") == "gpu_user_annotation" and e.get("name", "").startswith("portbench."):
            spans[e["name"][len("portbench."):]] += (end - start) / 1e6
        elif e.get("cat") in DEVICE_CATS:
            device.append((e.get("name", ""), start, end))
        elif e.get("cat") in HOST_CATS and e.get("name") != WINDOW_SPAN:
            host.append((e.get("name", ""), start, end))
    return device, host, dict(spans), hi - lo


def merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def device_busy_us(device: List[Tuple[str, float, float]]) -> float:
    """The union of the device intervals."""
    return sum(hi - lo for lo, hi in merged([(s, e) for _, s, e in device]))


def breakdown(device, host, window_us: float, top: int = 10) -> Dict[str, List[List[Any]]]:
    """The device operations that took most time, and the longest idle
    gaps of the device by what the host was doing in them (the innermost
    host event at the gap's middle), in seconds."""
    by_name: Dict[str, float] = defaultdict(float)
    for name, s, e in device:
        by_name[name[:120]] += (e - s) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = merged([(s, e) for _, s, e in device])
    gaps = []
    edges = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    for lo, hi in sorted(edges, key=lambda g: g[0] - g[1])[:top]:
        mid = (lo + hi) / 2
        around = [h for h in host if h[1] <= mid <= h[2]]
        name = max(around, key=lambda h: h[1])[0] if around else "nothing traced"
        gaps.append([name[:120], (hi - lo) / 1e6])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": gaps}


class Context:
    """What a per-layer metric's reader reads (``read(ctx)``)."""

    def __init__(self, cell, window_s: float, busy_s: float, device, counters: Dict[str, float],
                 spans: Dict[str, List[float]], device_spans: Dict[str, float], kernels_of):
        self.cell = cell
        self.window_s = window_s
        self.busy_s = busy_s
        self.device = device  # [(name, start_us, end_us)] in the traced window
        self.counters = counters  # each counter's change over the traced window
        self.spans = spans  # the harness's spans in the traced window, host clock: {name: [seconds]}
        self.device_spans = device_spans  # the same spans' seconds on the device: {name: seconds}
        self.kernels_of = kernels_of  # operation -> its kernel files

    def kernel_seconds(self, operation: str) -> float:
        """Device seconds of the kernels of ``operation`` in the window."""
        names = [n for k in self.kernels_of(operation) for n in k["trace_names"]]
        return sum(e - s for name, s, e in self.device if any(n in name for n in names)) / 1e6
