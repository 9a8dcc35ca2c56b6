"""Device milliseconds a dispatched batch of the kernels and copies
launched inside the program's ``deid.encode`` ranges: the generator's
encoder (``gen.encode``), once a batch.  Read as the device's busy time
inside the profiler's device-side copies of those ranges
(``portbench/spans.py``)."""

from portbench.spans import device_ms

LAYER = "de-id pipeline (deid.py)"
SOURCE = "device_trace"
MOVES = "images_per_s"


def read(ctx):
    return device_ms(ctx, ("deid.encode",))
