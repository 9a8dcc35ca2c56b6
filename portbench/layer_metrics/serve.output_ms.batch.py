"""Device milliseconds a dispatched batch of the output path: the kernels
and copies launched inside the program's ``deid.cast`` (bf16 to f32),
``serve.quantize`` (to uint8) and ``serve.drain`` (the copy to the host)
ranges, read as the device's busy time inside the profiler's
device-side copies of those ranges (``portbench/spans.py``)."""

from portbench.spans import device_ms

LAYER = "de-id server (serve.py)"
SOURCE = "device_trace"
MOVES = "images_per_s"


def read(ctx):
    return device_ms(ctx, ("deid.cast", "serve.quantize", "serve.drain"))
