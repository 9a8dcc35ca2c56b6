"""Device milliseconds a step of the kernels launched inside the
program's ``caption.decoder`` range (the decoder's forward)."""

LAYER = "decoder (models/captioner.py)"
SOURCE = "device_trace"
MOVES = "step_s"


def read(ctx):
    if not ctx.res.get("steps"):
        return None
    ms = ctx.trace.span_ms(ctx.work["spans"]).get("caption.decoder")
    return ms / ctx.res["steps"] if ms else None
