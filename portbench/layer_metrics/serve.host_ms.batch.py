"""Host milliseconds a dispatched batch of the server's own path: its
``stats()`` counters ``assemble_s`` + ``upload_s`` + ``launch_s`` (check,
pad and stack; the pinned upload; enqueueing the pipeline)."""

from portbench.spans import counter_ms_per_batch

LAYER = "de-id server (serve.py)"
SOURCE = "host_clock"
MOVES = "images_per_s"


def read(ctx):
    return counter_ms_per_batch(ctx, ("assemble_s", "upload_s", "launch_s"))
