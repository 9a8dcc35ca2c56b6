"""Device idle milliseconds a dispatched batch while the main thread was
in the server's host path: the window's idle intervals intersected with
its ``serve.assemble``, ``serve.upload`` and ``serve.launch`` ranges."""

from portbench.spans import SERVE_HOST, idle_ms

LAYER = "de-id server (serve.py)"
SOURCE = "device_trace"
MOVES = "images_per_s"


def read(ctx):
    return idle_ms(ctx, SERVE_HOST)
