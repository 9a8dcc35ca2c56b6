"""Device idle milliseconds a step while the main thread was inside the
program's ``caption.backward`` range (the backward and its gradient
all-reduce): the window's idle intervals intersected with that range."""

from portbench.spans import idle_ms

LAYER = "caption trainer backward (train/caption.py)"
SOURCE = "device_trace"
MOVES = "step_s"


def read(ctx):
    return idle_ms(ctx, ("caption.backward",), per="steps")
