"""Whole de-id pipeline's share of the bf16 peak: the reference's FLOPs
of the outputs delivered in the traced window (through the drain) over
the window's seconds times 989 TFLOP/s."""

from portbench.work import BF16_FLOP_S

LAYER = "de-id pipeline (deid.py)"
SOURCE = "device_trace"
MOVES = "images_per_s"


def read(ctx):
    if not ctx.res["outputs"]:
        return None
    return 100.0 * ctx.work["flops_per_output"] * ctx.res["outputs"] / (ctx.trace.window_s * BF16_FLOP_S)
