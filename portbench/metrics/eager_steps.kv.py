"""The share of the traced window's steps that ran eagerly (outside a CUDA-graph replay): the leftovers of each epoch, in percent."""
from portbench.harness import readers


def read(ctx):
    return readers.eager_percent(ctx)
