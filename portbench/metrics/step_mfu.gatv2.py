"""The model FLOPs of the traced window's steps over its seconds at the card's float32 peak outside the tensor cores (67 TFLOP/s), in percent; counted by the configuration's cost functions. The configuration computes in float32 with TF32 off, so float32's peak, not bf16's."""
from portbench.harness.families.common import PEAK_FLOPS


def read(ctx):
    flops = ctx.counters.get("model_flops", 0.0)
    if flops <= 0 or ctx.window_s <= 0:
        return None
    return 100.0 * flops / (ctx.window_s * PEAK_FLOPS["float32"])
