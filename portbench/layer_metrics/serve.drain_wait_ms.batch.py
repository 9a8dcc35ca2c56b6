"""Host milliseconds a dispatched batch blocked in the drain's copy to
the host: the server's ``stats()`` counter ``drain_wait_s``."""

from portbench.spans import counter_ms_per_batch

LAYER = "de-id server (serve.py)"
SOURCE = "host_clock"
MOVES = "images_per_s"


def read(ctx):
    return counter_ms_per_batch(ctx, ("drain_wait_s",))
