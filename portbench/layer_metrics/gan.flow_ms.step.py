"""Device milliseconds a step inside the program's ``gan.flow`` ranges:
RAFT's forward in the flow loss, twice a step (each generator
sub-step), at the configuration's refinement iterations."""

from portbench.gan_spans import device_ms

LAYER = "RAFT flow loss (models/raft.py)"
SOURCE = "device_trace"
MOVES = "step_s"


def read(ctx):
    return device_ms(ctx, ("gan.flow",))
