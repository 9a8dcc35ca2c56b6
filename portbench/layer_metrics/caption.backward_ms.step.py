"""Device milliseconds a step of the kernels that autograd's engine
launched (the caption step's backward, encoder and decoder)."""

LAYER = "caption trainer backward (train/caption.py)"
SOURCE = "device_trace"
MOVES = "step_s"


def read(ctx):
    if not ctx.res.get("steps"):
        return None
    ms = ctx.trace.span_ms(ctx.work["spans"]).get("backward")
    return ms / ctx.res["steps"] if ms else None
