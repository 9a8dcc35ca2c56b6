"""The conv3x3 kernel's share of its roofline: the least time of the
cell's stride-1 3x3 convs (the reference's, taped a batch, times the
batches dispatched in the window) over the device time of the kernel
``conv3x3_kernel`` with winograd.cu's ``StoreOut`` epilogue."""

from portbench.work import kernel_bound_s

LAYER = "kernels (ops, csrc)"
SOURCE = "device_trace"
MOVES = "images_per_s"


def _ours(name: str) -> bool:
    return "conv3x3_kernel" in name and "StoreOut" in name


def read(ctx):
    t = ctx.trace.device_s(_ours)
    batches = ctx.res["counters"].get("batches_dispatched", 0)
    if t <= 0 or not batches:
        return None
    return 100.0 * kernel_bound_s(ctx.work["tape_per_batch"], "conv3x3") * batches / t
