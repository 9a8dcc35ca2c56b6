"""A training step's share of the bf16 peak: the reference's FLOPs of a
step (forward and backward) times the steps of the traced window, over
the window's seconds times 989 TFLOP/s."""

from portbench.work import BF16_FLOP_S

LAYER = "trainer step (train/caption.py)"
SOURCE = "device_trace"
MOVES = "step_s"


def read(ctx):
    if not ctx.res.get("steps"):
        return None
    return 100.0 * ctx.work["flops_per_step"] * ctx.res["steps"] / (ctx.trace.window_s * BF16_FLOP_S)
