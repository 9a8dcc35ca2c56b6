"""The device's idle share of the traced window: 1 - the union of its
kernel, copy and memset intervals over the window's length."""

LAYER = "device"
SOURCE = "device_trace"
MOVES = "images_per_s"


def read(ctx):
    w = ctx.trace.window_s
    return 100.0 * (1.0 - ctx.trace.busy_s / w) if w > 0 else None
