"""A GAN training iteration's share of the bf16 peak: the reference's
FLOPs of an iteration (forward, backward and R1's double backward,
counted on meta tensors; not the elementwise work, the camera's FFTs,
the optimizers or the EMA) times the steps of the traced window, over
the window's seconds times 989 TFLOP/s."""

from portbench.work import BF16_FLOP_S

LAYER = "GAN trainer step (train/gan.py)"
SOURCE = "device_trace"
MOVES = "step_s"


def read(ctx):
    if not ctx.res.get("steps") or not ctx.trace.device or ctx.trace.window_s <= 0:
        return None
    return 100.0 * ctx.work["flops_per_step"] * ctx.res["steps"] / (ctx.trace.window_s * BF16_FLOP_S)
