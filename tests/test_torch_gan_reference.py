"""The port's GAN training step (``train/gan.py``) against the benchmark's
plain reference step (``portbench/reference/gan.py``), on the CPU in
float32.  Imports no JAX.

Both sides start from the same seeded state dicts at the benchmark
driver's toy size (64^2, ``max_conv_dim`` 32, batch 2, the FANs at 64^2,
LPIPS, a 2-iteration RAFT flow loss on three correlation levels) and
take two iterations (the toy's rehearsal checks one): the
port through ``make_train_step`` with its frozen nets and its LPIPS and
flow callables, each sub-step's gradients kept through
``grad_hook``; the reference applies the port's gradients in place of
its own, so each of its sub-steps takes its gradient at the weights the
port had, and its Adam and EMA run on the same gradients.
"""

import pytest
import torch

from portbench import run
from portbench.kinds import gan_steps
from portbench.reference import gan as ref

SEED = 4294967311
# The reference's own generator-side gradients move by up to 4.3e-3 when
# its weights move by 1e-7 (about an ulp; toy size, random weights: the
# instance norms of near-constant channels amplify rounding), and the
# port reaches them through other op orders and conv algorithms: its
# generator, mapping-network and style-encoder gradients read 0.2-2.6%
# from the reference's.  The discriminator's read 2e-5-9.5e-4.
G_GRAD_TOL = 0.08
D_GRAD_TOL = 5e-3
# A loss term is a forward number: f32 rounding through the nets, 1.6e-5.
LOSS_TOL = 2e-4
# The part of a gradient a fault would take out (R1's term, the flow
# term), as a coefficient of the port's gradient: 1 within these (read
# 1e-3 and 3.6e-3; the planted faults read 0).
R1_COEF_TOL = 0.05
FLOW_COEF_TOL = 0.05
# The same gradients through two Adams and two EMAs: f32 op order only.
STATE_TOL = 1e-5


@pytest.fixture(scope="module")
def both():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        wl, cfg, mix = run.cell_files(run.load_spec(), "deid256-train")
        for part, d in (("config", cfg), ("mix", mix)):
            for k, v in gan_steps.TOY[part].items():
                d[k] = {**d[k], **v} if isinstance(v, dict) and isinstance(d.get(k), dict) else v
        mix["check_steps"] = 2
        cell = gan_steps.prepare(cfg, mix, SEED, torch.device("cpu"))
        steps = mix["check_steps"]
        r = ref.train_steps(cell.states, cfg, cell.ring[:steps], follow=cell.grads, parts=True)
        yield cell, r
    finally:
        torch.set_num_threads(n)


def test_two_iterations_ran_every_sub_step(both):
    cell, r = both
    assert len(cell.grads) == len(r["grads"]) == 2
    for got, want in zip(cell.grads, r["grads"]):
        assert set(got) == set(want) == {sub for sub, _ in ref.SUBSTEPS}
        for sub in want:
            assert set(got[sub]) == set(want[sub])


@pytest.mark.parametrize("step", [0, 1])
def test_loss_terms_match(both, step):
    cell, r = both
    got, want = cell.losses[step], r["losses"][step]
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=LOSS_TOL, abs=1e-6), k


@pytest.mark.parametrize("sub,nets", ref.SUBSTEPS)
@pytest.mark.parametrize("step", [0, 1])
def test_sub_step_gradients_match(both, step, sub, nets):
    cell, r = both
    got, want = cell.grads[step][sub], r["grads"][step][sub]
    tol = D_GRAD_TOL if sub.startswith("D/") else G_GRAD_TOL
    for net in nets:
        gap = gan_steps._rel(got, want, [k for k in want if k[0] == net])
        assert gap < tol, (net, gap)
    part = r["part_grads"][step][sub]
    coef = gan_steps._coef(got, want, part)
    if sub.startswith("D/"):
        assert abs(coef - 1) < R1_COEF_TOL, coef
    elif sub == "G/latent":
        assert abs(coef - 1) < FLOW_COEF_TOL, coef


@pytest.mark.parametrize("which", ["after", "ema"])
def test_state_after_two_iterations_matches(both, which):
    cell, r = both
    got, want = getattr(cell, which), r[which]
    for net in want:
        keys = list(want[net])
        d_got = {k: got[net][k].float() - cell.states[net][k].float() for k in keys}
        d_want = {k: want[net][k] - cell.states[net][k].float() for k in keys}
        assert float(sum(torch.linalg.vector_norm(v) for v in d_want.values())) > 0, net
        assert gan_steps._rel(d_got, d_want, keys) < STATE_TOL, net
