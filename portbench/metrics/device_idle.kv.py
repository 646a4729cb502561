"""Idle share of the device in the traced window of a kv cell: 1 - the union of kernel, copy and memset intervals over the window (torch.profiler), in percent."""
from portbench.harness import readers


def read(ctx):
    return readers.idle_percent(ctx)
