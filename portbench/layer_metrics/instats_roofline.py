"""The instats kernel's share of its roofline: the least time of the
cell's instance-norm moments (the reference's, taped a batch, times the
batches dispatched in the window) over the device time of the kernel
``moments_kernel``."""

from portbench.work import kernel_bound_s

LAYER = "kernels (ops, csrc)"
SOURCE = "device_trace"
MOVES = "images_per_s"


def read(ctx):
    t = ctx.trace.device_s(lambda n: "moments_kernel" in n)
    batches = ctx.res["counters"].get("batches_dispatched", 0)
    if t <= 0 or not batches:
        return None
    return 100.0 * kernel_bound_s(ctx.work["tape_per_batch"], "instats") * batches / t
