"""Arithmetic the per-layer metrics' readers share (``portbench/metrics``).
Each returns ``None`` where the traced window holds nothing to read; a
share is in percent."""
from __future__ import annotations

from typing import Optional

from portbench.harness.families.common import BF16_PEAK_FLOPS


def idle_percent(ctx) -> Optional[float]:
    """The share of the traced window in which no kernel, copy or memset
    ran on the device."""
    if ctx.window_s <= 0 or ctx.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)


def mfu_percent(ctx) -> Optional[float]:
    """The model FLOPs of the window's steps (and evals) over the window's
    seconds at the card's bf16 peak."""
    flops = ctx.counters.get("model_flops", 0.0)
    if flops <= 0 or ctx.window_s <= 0:
        return None
    return 100.0 * flops / (ctx.window_s * BF16_PEAK_FLOPS)


def roofline_percent(ctx, operation: str) -> Optional[float]:
    """The least time of the operation's work in the window (each launch
    at the larger of its bytes at HBM's rate and its FLOPs at the peak)
    over the device time of its kernels in the trace."""
    seconds = ctx.kernel_seconds(operation)
    bound = ctx.counters.get(f"bound_s.{operation}", 0.0)
    if seconds <= 0 or bound <= 0:
        return None
    return 100.0 * bound / seconds


def device_span_percent(ctx, name: str) -> Optional[float]:
    """The share of the traced window in which the device ran the work
    launched inside the harness's span ``name``."""
    seconds = ctx.device_spans.get(name, 0.0)
    if seconds <= 0 or ctx.window_s <= 0:
        return None
    return 100.0 * seconds / ctx.window_s


def eager_percent(ctx) -> Optional[float]:
    """The steps that ran outside a replay, over all steps of the window."""
    steps = ctx.counters.get("steps", 0)
    if steps <= 0:
        return None
    return 100.0 * ctx.counters.get("eager_steps", 0) / steps

