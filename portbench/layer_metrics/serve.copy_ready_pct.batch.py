"""Percent of the server's drains that found their batch's copy to the
host already done when they began: its ``stats()`` counters
``copies_ready`` over ``batches_dispatched``.  The copy runs on the
server's copy stream beside the next batches' kernels; a drain that
finds it done does not hold the serving thread."""

LAYER = "de-id server (serve.py)"
SOURCE = "host_clock"
MOVES = "images_per_s"


def read(ctx):
    c = ctx.res.get("counters", {})
    n = int(c.get("batches_dispatched") or 0)
    if not n or "copies_ready" not in c:
        return None
    return 100.0 * c["copies_ready"] / n
