"""The model FLOPs of the traced window's steps over its seconds at the card's bf16 peak (989 TFLOP/s), in percent; counted by the configuration's cost functions."""
from portbench.harness import readers


def read(ctx):
    return readers.mfu_percent(ctx)
