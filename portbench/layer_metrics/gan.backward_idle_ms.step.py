"""Device idle milliseconds a step while the main thread was inside the
program's ``gan.backward`` ranges (each sub-step's ``autograd.grad``
and its gradient all-reduce): the window's idle intervals intersected
with those ranges."""

from portbench.gan_spans import idle_ms

LAYER = "GAN trainer backward (train/gan.py)"
SOURCE = "device_trace"
MOVES = "step_s"


def read(ctx):
    return idle_ms(ctx, ("gan.backward",))
