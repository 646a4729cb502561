"""The dense relational aggregation's roofline share: its least time over the device time of the kernels of portbench/kernels/relagg/ (K1, K2, K3), in percent."""
from portbench.harness import readers


def read(ctx):
    return readers.roofline_percent(ctx, "relagg")
