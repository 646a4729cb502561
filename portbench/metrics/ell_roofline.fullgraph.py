"""The graph aggregation's roofline share: its least time (bytes at 3.35 TB/s or FLOPs at the peak, per launch, from the configuration's cost functions) over the device time of the kernels of portbench/kernels/ell/, in percent."""
from portbench.harness import readers


def read(ctx):
    return readers.roofline_percent(ctx, "ell")
