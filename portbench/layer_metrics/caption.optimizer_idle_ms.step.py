"""Device idle milliseconds a step while the main thread was inside the
program's ``caption.optimizer`` range (the three Adams and the
batch-norm commit): the window's idle intervals intersected with that
range."""

from portbench.spans import idle_ms

LAYER = "trainer step (train/caption.py)"
SOURCE = "device_trace"
MOVES = "step_s"


def read(ctx):
    return idle_ms(ctx, ("caption.optimizer",), per="steps")
