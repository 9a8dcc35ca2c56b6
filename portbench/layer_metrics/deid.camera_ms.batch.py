"""Device milliseconds a dispatched batch of the kernels and copies
launched inside the program's ``deid.camera`` ranges: the learned-optics
camera (``camera_apply``).  Read as the device's busy time inside the
profiler's device-side copies of those ranges (``portbench/spans.py``)."""

from portbench.spans import device_ms

LAYER = "de-id pipeline (deid.py)"
SOURCE = "device_trace"
MOVES = "images_per_s"


def read(ctx):
    return device_ms(ctx, ("deid.camera",))
