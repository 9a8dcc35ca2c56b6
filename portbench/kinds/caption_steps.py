"""Caption training steps through the port's ``make_caption_train_step``.

Set-up builds one train state (the lens, the ResNet-101 encoder in the
configuration's dtype, the decoder, three Adams), loads the benchmark's
weights into it, and drives it through its first ``check_steps`` steps
on batches that all differ, through the same call and feed as the
window: those steps warm every shape, and their losses, the first
gradient each Adam received (its first moment after one step over
1 - beta1) and the state after the last of them are kept for the
reference.  The window then steps the same state over a ring of seeded
batches until ``--seconds`` have passed, and ends in a synchronize;
``step_s`` is the window's seconds over its steps.

The mix file gives ``batch_size``, ``caption_tokens`` (padded width),
``words`` (the range of caption lengths, the same multiset in every
batch), ``ring`` (distinct batches) and ``check_steps``.
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import torch

from .. import inputs, weights
from ..reference import caption as ref
from ..work import flops

__all__ = ["prepare", "drive", "free", "judge", "work"]

MODULES = ("camera", "encoder", "decoder")
# The reference put in the program's place for the checked steps.  The
# controls, each a stated precision one step lower: "fp8", the encoder's
# convs in float8 e4m3 (below its bf16) with the float32 products in
# TF32; "bf16_decoder", the decoder, its cross-entropy and attention term
# in bfloat16 (below its float32), the encoder's convs rounded to its
# bf16.  A planted fault: "half_batch", the cross-entropy over half of
# the captions.
VARIANTS = {
    "fp8": dict(cast=ref.fp8, tf32=True),
    "bf16_decoder": dict(cast=ref.bf16, dec_dtype=torch.bfloat16),
    "half_batch": dict(half=True),
}
# The numbers of ``judge`` that decide ``correct``, each against its limit.
COMPARED = ("first_grad_gap_median", "change_gap_median", "bn_step1_diff_median", "decoder_grad_gap_median")
SPANS = ("caption.camera", "caption.encoder", "caption.decoder", "caption.loss", "caption.optimizer")
# What the harness's tests read of this driver.  ``TOY``: the entries of
# the configuration and the mix that the CPU rehearsal changes, small
# enough to run a whole cell in seconds on a few CPU threads.
# ``CONTROLS``: the variants a stated precision lower that must read not
# correct at the cell's own size on the card.  ``FAULTS``: the variants
# that a CPU rehearsal must read not correct.
TOY = {
    "config": {"vocab_size": 40, "encoder": {"stages": [1, 1, 1, 1], "compute_dtype": "float32"},
               "caption": {"encoded_image_size": 4},
               "lens": {"wave_res": 64, "patch_size": 32, "zernike_terms": 10, "mask_radius_px": 8}},
    "mix": {"batch_size": 4, "caption_tokens": 8, "words": [2, 4], "ring": 4, "check_steps": 3},
}
CONTROLS = ("fp8",)
FAULTS = ("fp8", "half_batch")


@dataclasses.dataclass
class Cell:
    cfg: dict
    mix: dict
    seed: int
    device: torch.device
    states: dict
    ring: list
    losses: list
    ces: list  # the checked steps' cross-entropies (the decoder's loss)
    first_grads: dict
    bn1: dict  # the encoder's batch-norm statistics after the first step
    after: dict
    program: object = None  # (train state, step function, generator)


def _batches(cfg, mix, seed, device, n):
    rng = inputs.seed_rng(seed, 6)
    out = []
    for i in range(n):
        caps, lens = inputs.caption_batch(rng, mix["batch_size"], mix["caption_tokens"], tuple(mix["words"]),
                                          cfg["vocab_size"])
        out.append(dict(images=inputs.smooth_images(mix["batch_size"], cfg["lens"]["patch_size"], seed, device,
                                                    stream=10 + i),
                        captions=torch.from_numpy(caps).to(device),
                        caption_lengths=torch.from_numpy(lens).to(device)))
    return out


def prepare(cfg: dict, mix: dict, seed: int, device, variant: str | None = None) -> Cell:
    from ppvision_tpu_torch.config import CaptionConfig
    from ppvision_tpu_torch.optics.lens import LensSpec, make_lens_constants
    from ppvision_tpu_torch.train.caption import init_caption, make_caption_train_step

    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"caption cells know the variants {sorted(VARIANTS)}, not {variant!r}")
    lens = {k: (tuple(v) if isinstance(v, list) else v) for k, v in cfg["lens"].items()}
    spec = LensSpec(**lens)
    ccfg = CaptionConfig(**cfg["caption"])
    consts = make_lens_constants(spec, device=device)
    enc = cfg["encoder"]
    state = init_caption(seed, ccfg, cfg["vocab_size"], spec, encoder_stages=tuple(enc["stages"]),
                         dtype=getattr(torch, enc["compute_dtype"]), device=device)
    mods = {k: getattr(state, k) for k in MODULES}
    shapes = {k: {n: tuple(t.shape) for n, t in m.state_dict().items()} for k, m in mods.items()}
    states = weights.make_states(shapes, cfg["init"], seed, device)
    for k, m in mods.items():
        m.load_state_dict(states[k])
    step = make_caption_train_step(ccfg, spec, consts)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    ring = _batches(cfg, mix, seed, device, mix["ring"])
    losses, ces, first = [], [], {}
    opts = {"camera": state.opt_camera, "encoder": state.opt_encoder, "decoder": state.opt_decoder}
    for t in range(mix["check_steps"]):
        m = step(state, ring[t], gen)
        losses.append(float(m["loss"]))
        ces.append(float(m["ce"]))
        if t == 0:
            bn1 = {k: v.detach().clone() for k, v in state.encoder.state_dict().items()
                   if k.endswith(("running_mean", "running_var"))}
            b1 = 0.9
            for m, mod in mods.items():
                for name, p in mod.named_parameters():
                    st = opts[m].state.get(p)
                    if st and ref.trainable(m, name):
                        first[(m, name)] = (st["exp_avg"] / (1 - b1)).clone()
    after = {m: {k: v.detach().clone() for k, v in mod.state_dict().items()} for m, mod in mods.items()}
    if variant is not None:
        v = VARIANTS[variant]
        g = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = v.get("tf32", False)
        try:
            losses, first, after, bn1, ces = ref.train_steps(
                states, cfg, ring[: mix["check_steps"]], g, cast=v.get("cast"),
                rows=mix["batch_size"] // 2 if v.get("half") else None, dec_dtype=v.get("dec_dtype"))
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    if device.type == "cuda":
        torch.cuda.synchronize()
    return Cell(cfg, mix, seed, device, states, ring, losses, ces, first, bn1, after, (state, step, gen))


def drive(cell: Cell, seconds: float, window) -> dict:
    state, step, gen = cell.program
    k = len(cell.ring)
    n = 0
    with window():
        t0 = time.perf_counter()
        t_end = t0 + seconds
        while time.perf_counter() < t_end:
            step(state, cell.ring[(cell.mix["check_steps"] + n) % k], gen)
            n += 1
        if cell.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return dict(attempted=n, failed=0, steps=n, metrics={"step_s": wall / n},
                notes=dict(steps=n, window_s=wall, setup_losses=cell.losses), counters={})


def free(cell: Cell) -> None:
    cell.program = None


def _leaf_gaps(got: dict, want: dict, keys, of_difference: bool = False) -> dict:
    """Each leaf's gap of norms (or, ``of_difference``, the norm of its
    difference), over the larger of that leaf's reference norm and the
    median leaf's."""
    norms = {k: float(torch.linalg.vector_norm(want[k].double())) for k in keys}
    if not norms:
        return {}
    med = statistics.median(norms.values())

    def gap(k):
        g, w = got[k].double(), want[k].double()
        if of_difference:
            return float(torch.linalg.vector_norm(g - w))
        return abs(float(torch.linalg.vector_norm(g)) - norms[k])

    return {k: gap(k) / max(norms[k], med, 1e-30) for k in keys}


def _median(gaps: dict) -> float:
    """The median leaf's gap; with no leaf to compare, no agreement."""
    return statistics.median(gaps.values()) if gaps else float("inf")


def judge(cell: Cell, res: dict) -> tuple[list, dict]:
    """The reference's first ``check_steps`` steps from the same weights,
    batches and generator seed.  Compared (each with its limit in the
    configuration): the median leaf's gap of norms of the first applied
    gradient and of the change of the state after the last step; the
    median batch-norm statistic's norm of the difference of its change in
    the first step (first order in the forward's rounding, which the gaps
    of norms are not, and before any update has moved the two sides
    apart); and, for the decoder, whose 18 leaves the median over all
    leaves never reaches, the median decoder leaf's gap of norms of the
    first gradient.  Reported beside them: each step's loss and
    cross-entropy gaps (the first step's before any update), the decoder
    leaves' norms of the first gradient's difference and change gaps,
    the median leaf's norm of the first gradient's difference and the
    worst leaves.  Leaves whose reference
    gradient is under a thousandth of the median leaf's are left out
    (round-off moves them)."""
    gen = torch.Generator(device=cell.device).manual_seed(int(cell.seed) % (2**63))
    n = cell.mix["check_steps"]
    losses, first, st, bn1, ces = ref.train_steps(cell.states, cell.cfg, cell.ring[:n], gen)
    gnorm = {k: float(torch.linalg.vector_norm(g.double())) for k, g in first.items()}
    med = statistics.median(gnorm.values())
    moved = [k for k in first if gnorm[k] >= 1e-3 * med]
    missing = [k for k in moved if k not in cell.first_grads]
    present = [k for k in moved if k not in missing]
    dec = [k for k in present if k[0] == "decoder"]
    grads = _leaf_gaps(cell.first_grads, first, present)
    grad_diffs = _leaf_gaps(cell.first_grads, first, present, of_difference=True)
    dec_diffs = _leaf_gaps(cell.first_grads, first, dec, of_difference=True)
    buffers = [(m, k) for m in MODULES for k in st[m] if k.endswith(("running_mean", "running_var"))]
    keys = moved + buffers
    d_prog = {k: cell.after[k[0]][k[1]].float() - cell.states[k[0]][k[1]].float() for k in keys}
    d_ref = {k: st[k[0]][k[1]].float() - cell.states[k[0]][k[1]].float() for k in keys}
    change = _leaf_gaps(d_prog, d_ref, keys)
    dec_moved = [k for k in moved if k[0] == "decoder"]
    bn_diffs = _leaf_gaps(d_prog, d_ref, buffers, of_difference=True)
    enc0 = cell.states["encoder"]
    bn1_diffs = _leaf_gaps({k: cell.bn1[k].float() - enc0[k].float() for k in bn1},
                           {k: bn1[k].float() - enc0[k].float() for k in bn1}, list(bn1), of_difference=True)
    rel = lambda got, want: [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, want)]  # noqa: E731
    loss_gaps, ce_gaps = rel(cell.losses, losses), rel(cell.ces, ces)
    numbers = {
        "first_grad_gap_median": _median(grads),
        "change_gap_median": _median(change),
        "bn_step1_diff_median": _median(bn1_diffs),
        "decoder_grad_gap_median": _median(_leaf_gaps(cell.first_grads, first, dec)),
        "decoder_grad_diff_median": _median(dec_diffs),
        "decoder_change_gap_median": _median(_leaf_gaps(d_prog, d_ref, dec_moved)),
        "ce_gap_step1": ce_gaps[0],
    }
    top = lambda d: sorted(((v, ".".join(k)) for k, v in d.items()), reverse=True)[:5]  # noqa: E731
    info = {"losses": cell.losses, "reference_losses": losses, "loss_gap": max(loss_gaps), "loss_gaps": loss_gaps,
            "ces": cell.ces, "reference_ces": ces, "ce_gaps": ce_gaps, **numbers,
            "moved_leaves": len(moved), "leaves": len(first), "decoder_leaves": len(dec),
            "first_grad_diff_median": _median(grad_diffs), "bn_stats_diff_median": _median(bn_diffs),
            "decoder_grad_diff_worst": top(dec_diffs), "first_grad_worst": top(grads), "change_worst": top(change)}
    limits = cell.cfg.get("limits", {})
    compared = [("leaves_without_state", float(len(missing)), 0.0)]
    compared += [(name, numbers[name], limits.get(name)) for name in COMPARED]
    return compared, info


def work(cell: Cell) -> dict:
    """FLOPs of one step (forward and backward of the reference) on meta
    tensors, the decoder's loop at the mix's longest caption."""
    mix = cell.mix
    meta = {m: {k: torch.empty(v.shape, device="meta", requires_grad=ref.trainable(m, k) and v.is_floating_point())
                for k, v in sd.items()} for m, sd in cell.states.items()}
    b, n = mix["batch_size"], cell.cfg["lens"]["patch_size"]
    batch = dict(images=torch.empty((b, n, n, 3), device="meta"),
                 captions=torch.empty((b, mix["caption_tokens"]), dtype=torch.long, device="meta"),
                 caption_lengths=torch.empty((b,), dtype=torch.long, device="meta"))
    leaves = [t for sd in meta.values() for t in sd.values() if t.requires_grad]

    def one_step():
        with torch.enable_grad():
            loss, _ = ref.step_loss(meta, cell.cfg, batch, None, steps=mix["words"][1] + 1)
            torch.autograd.grad(loss, leaves, allow_unused=True)

    total, _ = flops.count(one_step)
    return dict(flops_per_step=total, spans=SPANS)
