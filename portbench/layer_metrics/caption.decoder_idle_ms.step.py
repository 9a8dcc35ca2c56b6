"""Device idle milliseconds a step while the main thread was inside the
program's ``caption.decoder`` range (the decoder's forward): the
window's idle intervals intersected with that range."""

from portbench.spans import idle_ms

LAYER = "decoder (models/captioner.py)"
SOURCE = "device_trace"
MOVES = "step_s"


def read(ctx):
    return idle_ms(ctx, ("caption.decoder",), per="steps")
