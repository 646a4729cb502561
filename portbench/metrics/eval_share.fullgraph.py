"""The share of the traced window in which the device ran eval_step's work (the harness's span around the call, as the profiler places it on the device), in percent."""
from portbench.harness import readers


def read(ctx):
    return readers.device_span_percent(ctx, "eval")
