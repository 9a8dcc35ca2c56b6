"""Face-DeId GAN training steps through the port's ``make_train_step``.

Set-up builds what the port's training CLI builds (``train.gan.init_gan``,
``train.pretrained.load_frozen_nets``, the LPIPS and RAFT-flow callables
of ``train.aux_losses``), loads the benchmark's weights into every net
and each EMA copy, and drives the train state through its first
``check_steps`` iterations on batches that all differ, through the same
call and feed as the window, with ``make_train_step``'s ``grad_hook``
keeping each sub-step's gradients: those iterations warm every shape,
and their losses, gradients and the state after the last of them are
kept for the reference.  The window then steps the same state over a
ring of seeded batches until ``--seconds`` have passed, and ends in a
synchronize; ``step_s`` is the window's seconds over its steps.

The mix file gives ``batch_size``, ``pool`` (seeded smooth images the
batches draw ``x_src``, ``x_ref`` and ``x_ref2`` from), ``ring``
(distinct batches) and ``check_steps``.  Domains are uniform over the
configuration's, latents N(0, 1); the camera forms the private images.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from .. import inputs, weights
from ..reference import caption as ref_caption
from ..reference import gan as ref
from ..work import flops

__all__ = ["prepare", "drive", "free", "judge", "work"]

# The reference put in the program's place for the checked steps.  The
# control, a stated precision one step lower: "fp8", every conv in
# float8 e4m3 (below the nets' bf16) with the float32 products in TF32.
# Planted faults: "no_r1", R1 left out of the discriminator's loss;
# "flow_detached", the flow term's gradient cut; "g_half_batch", both
# generator sub-steps' losses over half the batch; "no_ema", the EMA left
# as it was.
VARIANTS = {
    "fp8": dict(cast=ref_caption.fp8, tf32=True),
    "no_r1": dict(fault="no_r1"),
    "flow_detached": dict(fault="flow_detached"),
    "g_half_batch": dict(fault="g_half_batch"),
    "no_ema": dict(fault="no_ema"),
}
# The numbers of ``judge`` that decide ``correct``, each against its limit
# in the configuration; and those compared where the nets compute in
# float32 (the CPU rehearsal's toy), against the configuration's
# ``limits["float32"]``: in bfloat16 at random weights the latent
# generator sub-step's gradients of G and the mapping network, and the
# parts of a gradient that R1 and the flow term add, lie under the
# gradients' rounding (PERF.md, section 2).
COMPARED = ("loss_gap", "d_grad_gap", "g_ref_grad_gap", "style_grad_gap", "g_norm_gap", "change_gap",
            "ema_change_gap")
COMPARED_F32 = ("g_grad_gap", "r1_coef_gap", "flow_coef_gap")
SPANS = ("gan.frozen", "gan.d_latent", "gan.d_ref", "gan.g_latent", "gan.g_ref", "gan.ema")
# The port's kernels, counted a step in the window.
KERNELS = ("fftconv", "denseblock", "instats", "conv3x3", "corr")
# What the harness's tests read of this driver.  ``TOY``: the entries of
# the configuration and the mix that the CPU rehearsal changes, small
# enough to run a whole cell in half a minute on a few CPU threads (one
# checked iteration; three correlation levels: RAFT's fourth would be
# 1x1 at 64^2).  ``CONTROLS``:
# the variants a stated precision lower that must read not correct at
# the cell's own size on the card.  ``FAULTS``: the variants that a CPU
# rehearsal must read not correct.
TOY = {
    "config": {"model": {"img_size": 64, "max_conv_dim": 32, "compute_dtype": "float32", "fan_input_size": 64},
               "camera": {"n": 64, "zernike_terms": 10}, "train": {"batch_size": 2, "flow_iters": 2},
               "raft": {"corr_levels": 3}},
    "mix": {"batch_size": 2, "pool": 6, "ring": 2, "check_steps": 1},
}
CONTROLS = ("fp8",)
FAULTS = ("no_r1", "flow_detached", "g_half_batch", "no_ema")
# Loss terms of a softplus of the discriminator's logits: saturated, near
# 0, they hold only rounding, so their gap is taken over at least 1.
ADVERSARIAL = ("_real", "_fake", "_adv")


@dataclasses.dataclass
class Cell:
    cfg: dict
    mix: dict
    seed: int
    device: torch.device
    states: dict
    ring: list
    losses: list  # [{term: float}] a checked step
    grads: list  # [{sub-step: {(net, name): tensor}}] a checked step
    after: dict  # {net: state dict} after the checked steps
    ema: dict  # {net: state dict} of the EMA copies after them
    program: object = None  # (train state, frozen nets, step function)


def _port_config(cfg: dict):
    from ppvision_tpu_torch.config import CameraConfig, FaceDeIdConfig, LossConfig, ModelConfig, PathsConfig, \
        TrainConfig

    m, t = cfg["model"], cfg["train"]
    model = ModelConfig(**{k: m[k] for k in ("img_size", "num_domains", "latent_dim", "hidden_dim", "style_dim",
                                             "w_hpf", "max_conv_dim", "compute_dtype", "fan_input_size")})
    train = TrainConfig(**{k: t[k] for k in ("batch_size", "lr", "f_lr", "beta1", "beta2", "weight_decay",
                                             "ema_beta", "use_lpips", "use_flow", "flow_iters", "remat")})
    cam = cfg["camera"]
    # No checkpoint path: the benchmark loads its own weights into every net.
    paths = PathsConfig(wing_path="", camera_ckpt="", lpips_path="", alexnet_path="", raft_path="")
    return FaceDeIdConfig(model=model, loss=LossConfig(**cfg["loss"]), train=train,
                          camera=CameraConfig(n=cam["n"], zernike_terms=cam["zernike_terms"]), paths=paths)


def _batches(cfg, mix, seed, device):
    """The ring: batches of seeded smooth images from a pool, domains
    and latents from a seeded generator on the device."""
    m, b, k = cfg["model"], mix["batch_size"], mix["ring"]
    pool = inputs.smooth_images(mix["pool"], m["img_size"], seed, device, stream=1)
    g = torch.Generator(device=device).manual_seed((int(seed) * 1000003 + 7) % (2**63))
    idx = torch.randint(0, mix["pool"], (k, 3, b), generator=g, device=device)
    dom = torch.randint(0, m["num_domains"], (k, 2, b), generator=g, device=device)
    z = torch.randn((k, 2, b, m["latent_dim"]), generator=g, device=device)
    return [dict(x_src=pool[idx[i, 0]], x_ref=pool[idx[i, 1]], x_ref2=pool[idx[i, 2]], y_src=dom[i, 0],
                 y_ref=dom[i, 1], z_trg=z[i, 0], z_trg2=z[i, 1]) for i in range(k)]


def prepare(cfg: dict, mix: dict, seed: int, device, variant: str | None = None) -> Cell:
    from ppvision_tpu_torch.train.aux_losses import build_flow_fn, build_lpips_fn
    from ppvision_tpu_torch.train.gan import EMA_NETS, init_gan, make_train_step
    from ppvision_tpu_torch.train.pretrained import load_frozen_nets

    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"GAN training cells know the variants {sorted(VARIANTS)}, not {variant!r}")
    pcfg = _port_config(cfg)
    state = init_gan(seed, pcfg, device)
    frozen = load_frozen_nets(pcfg, seed, device)
    r, tr = cfg["raft"], pcfg.train
    mods = dict(state.nets, camera=frozen.camera, fan=frozen.fan, fan_priv=frozen.fan_priv)
    lpips_fn = flow_fn = None
    if tr.use_lpips:
        lpips_fn, mods["lpips"] = build_lpips_fn(None, seed, device)
    if tr.use_flow:
        flow_fn, mods["raft"] = build_flow_fn(None, seed, tr.flow_iters, r["corr_levels"], r["corr_radius"], device)
    shapes = {k: {n: tuple(t.shape) for n, t in m.state_dict().items()} for k, m in mods.items()}
    states = weights.make_states(shapes, cfg["init"], seed, device)
    for k, m in mods.items():
        m.load_state_dict(states[k])
    for k in EMA_NETS:
        state.ema[k].load_state_dict(states[k])
    ring = _batches(cfg, mix, seed, device)
    names = {k: [n for n, _ in net.named_parameters()] for k, net in state.nets.items()}
    grads: list = []

    def keep(sub, by_net):
        grads[-1][sub] = {(k, n): g.detach().clone() for k, gs in by_net.items() for n, g in zip(names[k], gs)}

    check = make_train_step(pcfg, lpips_fn, flow_fn, grad_hook=keep)
    losses = []
    for i in range(mix["check_steps"]):
        grads.append({})
        losses.append({k: float(v) for k, v in check(state, frozen, ring[i]).items()})
    after = {k: {n: v.detach().clone() for n, v in net.state_dict().items()} for k, net in state.nets.items()}
    ema = {k: {n: v.detach().clone() for n, v in net.state_dict().items()} for k, net in state.ema.items()}
    if variant is not None:
        v = VARIANTS[variant]
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = v.get("tf32", False)
        try:
            out = ref.train_steps(states, cfg, ring[: mix["check_steps"]], cast=v.get("cast"), fault=v.get("fault"))
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        losses, grads, after, ema = out["losses"], out["grads"], out["after"], out["ema"]
    if device.type == "cuda":
        torch.cuda.synchronize()
    step = make_train_step(pcfg, lpips_fn, flow_fn)
    return Cell(cfg, mix, seed, device, states, ring, losses, grads, after, ema, (state, frozen, step))


def _launches() -> dict:
    from ppvision_tpu_torch.ops import KERNELS as K

    return {k: K[k].launches for k in KERNELS}


def drive(cell: Cell, seconds: float, window) -> dict:
    state, frozen, step = cell.program
    k = len(cell.ring)
    n = 0
    before = _launches()
    with window():
        t0 = time.perf_counter()
        t_end = t0 + seconds
        while time.perf_counter() < t_end:
            step(state, frozen, cell.ring[(cell.mix["check_steps"] + n) % k])
            n += 1
        if cell.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counters = {"steps": n, **{f"{name}.launches": (c - before[name]) / n for name, c in _launches().items()}}
    return dict(attempted=n, failed=0, steps=n, metrics={"step_s": wall / n},
                notes=dict(steps=n, window_s=wall), counters=counters)


def free(cell: Cell) -> None:
    cell.program = None


def _rel(got: dict, want: dict, keys) -> float:
    """The norm of the difference over the norm of ``want``, both taken
    over all of ``keys`` as one vector (float64 sums)."""
    num = den = 0.0
    for key in keys:
        w = want[key].double()
        num += float(torch.sum((got[key].double() - w) ** 2))
        den += float(torch.sum(w * w))
    return (num / den) ** 0.5 if den > 0 else (0.0 if num == 0 else float("inf"))


def _norm_gap(got: dict, want: dict, keys) -> float:
    """The gap of the norms of ``got`` and ``want`` over ``keys``,
    relative to ``want``'s."""
    ng = sum(float(torch.sum(got[k].double() ** 2)) for k in keys) ** 0.5
    nw = sum(float(torch.sum(want[k].double() ** 2)) for k in keys) ** 0.5
    return abs(ng - nw) / max(nw, 1e-30)


def _coef(got: dict, want: dict, part: dict) -> float:
    """How much of the reference's ``part`` of a gradient the program's
    gradient holds: the coefficient of ``part`` in ``got`` less the rest
    of the reference's gradient, <got - (want - part), part> / |part|^2
    (1 where the program computed that part, 0 where it left it out;
    1 where the part is zero, which no program can leave out)."""
    num = den = 0.0
    for key, p in part.items():
        if key in got:
            p64 = p.double()
            num += float(torch.sum((got[key].double() - want[key].double() + p64) * p64))
            den += float(torch.sum(p64 * p64))
    return num / den if den > 0 else 1.0


def _worst(values) -> float:
    """The largest of ``values``; NaN if any is NaN (``max`` would pass
    it over)."""
    values = list(values)
    return float("nan") if any(v != v for v in values) else max(values, default=float("inf"))


def judge(cell: Cell, res: dict) -> tuple[list, dict]:
    """The reference's first ``check_steps`` iterations from the same
    weights and batches, applying the program's gradients in place of
    its own, so that every sub-step's gradient is taken at the weights
    the program had.  Compared (each with its limit in the
    configuration):

    - ``loss_gap``: the largest relative gap of a loss term over the
      checked iterations (forward numbers); an adversarial term's gap is
      taken over at least 1;
    - ``d_grad_gap``: the largest relative gap of a discriminator
      sub-step's whole gradient;
    - ``g_ref_grad_gap``: the largest relative gap of G's gradient in a
      reference-style generator sub-step (LPIPS leads it);
    - ``style_grad_gap``: the largest of the style encoder's in a latent
      generator sub-step;
    - ``g_norm_gap``: the largest relative gap of a gradient's norm over
      the generator sub-steps and each net they update;
    - ``change_gap``, ``ema_change_gap``: the largest relative gap of a
      net's change and of an EMA copy's change over the checked steps
      (the same gradients through the program's Adam and EMA and the
      reference's).

    Where the nets compute in float32, also the largest relative gap of
    a generator sub-step's gradient of G and how far from 1 the
    coefficients of R1's part of each discriminator gradient and of the
    flow term's part of the latent generator sub-step's lie.  Reported
    beside them: every term's gap, each sub-step's gap by net, the gaps
    of norms and every coefficient."""
    n = cell.mix["check_steps"]
    r = ref.train_steps(cell.states, cell.cfg, cell.ring[:n], follow=cell.grads, parts=True)
    missing = sum(1 for t in range(n) for sub, g in r["grads"][t].items() for key in g if key not in cell.grads[t]
                  .get(sub, {}))
    loss_gaps = [{k: abs(cell.losses[t].get(k, float("nan")) - v) / max(abs(v), 1.0 if k.endswith(ADVERSARIAL)
                                                                       else 1e-6)
                  for k, v in r["losses"][t].items() if k != "G/lambda_ds"} for t in range(n)]
    by_sub: dict = {}
    norm_gaps: dict = {}
    for t in range(n):
        for sub, names in ref.SUBSTEPS:
            want, got = r["grads"][t][sub], cell.grads[t].get(sub, {})
            keys = [k for k in want if k in got]
            by_sub[f"{t + 1}:{sub}"] = {net: _rel(got, want, [k for k in keys if k[0] == net]) for net in names}
            by_sub[f"{t + 1}:{sub}"]["all"] = _rel(got, want, keys)
            for net in names:
                norm_gaps[f"{t + 1}:{sub}:{net}"] = _norm_gap(got, want, [k for k in keys if k[0] == net])
    d_prog = {(k, m): cell.after[k][m].float() - cell.states[k][m].float() for k in ref.NETS for m in cell.after[k]}
    d_ref = {(k, m): r["after"][k][m].float() - cell.states[k][m].float() for k in ref.NETS for m in r["after"][k]}
    e_prog = {(k, m): cell.ema[k][m].float() - cell.states[k][m].float() for k in ref.EMA_NETS for m in cell.ema[k]}
    e_ref = {(k, m): r["ema"][k][m].float() - cell.states[k][m].float() for k in ref.EMA_NETS for m in r["ema"][k]}
    change = {k: _rel(d_prog, d_ref, [key for key in d_ref if key[0] == k]) for k in ref.NETS}
    ema_change = {k: _rel(e_prog, e_ref, [key for key in e_ref if key[0] == k]) for k in ref.EMA_NETS}
    coefs = {}
    for t in range(n):
        for sub, names in ref.SUBSTEPS:
            part, got = r["part_grads"][t].get(sub), cell.grads[t].get(sub, {})
            if part is not None:
                coefs[f"{t + 1}:{sub}"] = _coef(got, r["grads"][t][sub], part)
    numbers = {
        "loss_gap": _worst(v for gaps in loss_gaps for v in gaps.values()),
        "d_grad_gap": _worst(v["all"] for s, v in by_sub.items() if ":D/" in s),
        "g_ref_grad_gap": _worst(v["generator"] for s, v in by_sub.items() if ":G/ref" in s),
        "style_grad_gap": _worst(v["style_encoder"] for s, v in by_sub.items() if ":G/latent" in s),
        "g_norm_gap": _worst(v for s, v in norm_gaps.items() if ":G/" in s),
        "g_grad_gap": _worst(v["generator"] for s, v in by_sub.items() if ":G/" in s),
        "r1_coef_gap": _worst(abs(v - 1) for s, v in coefs.items() if ":D/" in s),
        "flow_coef_gap": _worst([abs(v - 1) for s, v in coefs.items() if ":G/latent" in s] or [0.0]),
        "change_gap": _worst(change.values()),
        "ema_change_gap": _worst(ema_change.values()),
    }
    top = lambda d: sorted(((v, k) for k, v in d.items()), reverse=True)[:6]  # noqa: E731
    info = {"losses": cell.losses, "reference_losses": r["losses"], **numbers,
            "loss_gaps_worst": [top(g) for g in loss_gaps], "grad_gaps": by_sub, "grad_norm_gaps": norm_gaps,
            "change_gaps": change, "ema_change_gaps": ema_change, "part_coefs": coefs}
    limits = cell.cfg.get("limits", {})
    compared = [("leaves_without_grad", float(missing), 0.0)]
    compared += [(name, numbers[name], limits.get(name)) for name in COMPARED]
    if cell.cfg["model"]["compute_dtype"] == "float32":
        compared += [(name, numbers[name], limits.get("float32", {}).get(name)) for name in COMPARED_F32]
    return compared, info


def work(cell: Cell) -> dict:
    """FLOPs of one iteration (forward, backward and R1's double
    backward of the reference) on meta tensors."""
    total, _ = flops.count(ref.counted_step, cell.states, cell.cfg, cell.mix["batch_size"])
    return dict(flops_per_step=total, spans=SPANS)
