"""The GAN trainer on two gloo ranks against one process.

The port's single-process step is held to the JAX package's by
``tests/test_torch_train_gan.py``; here two ranks, each with its half of
the global batch, must compute what one process computes on the whole
of it, at f64: one step at the ``TINY`` widths with the full loss
(LPIPS, RAFT flow, the heatmap L1), B = 4, two a rank, with and without
``remat`` (whose recomputed forward runs the skip mean's collective again
in the backward).

- The metrics within ``REL`` (1e-10) of the single process's, relative
  to max(|value|, 1e-3) as ``tests/test_torch_train_gan.py`` divides
  them.
- Each sub-step's gradients within ``REL`` of the largest of the net's.
- Every parameter and EMA parameter within ``REL`` of max(1, |value|).
  A parameter whose gradient is rounding residue (at most ``RESIDUE`` of
  the net's largest: the biases of the convs an InstanceNorm follows,
  which it removes, so their true gradient is 0) takes Adam's step of
  that residue, sign(g) * lr * |g| / (|g| + eps), which no two summation
  orders agree on: it is held to Adam's bound on one step, lr, instead.
- The two ranks end with the same state, bit for bit.
"""

import functools

import pytest
import torch

from . import torch_ranks
from .torch_parity import two_threads  # noqa: F401

REL = 1e-10
RESIDUE = 1e-9
GAN_B = 4


def _close_params(got: dict, want: dict, residue=frozenset(), lr: float = 0.0) -> None:
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if not w.is_floating_point():
            assert torch.equal(g, w), k
            continue
        d = float((g.double() - w.double()).abs().max())
        bound = lr if k.removeprefix("ema.") in residue else REL * max(1.0, float(w.double().abs().max()))
        assert d <= bound, (k, d, bound)


@functools.cache
def gan_single():
    """The step on one process (its two threads), once for the file: the
    tests start their ranks first and compute it while those run."""
    cfg = torch_ranks.gan_cfg("float64")
    grads = {}
    state, frozen, step = torch_ranks.build_gan(cfg, grads)
    batch = torch_ranks.gan_batch(GAN_B, cfg)
    metrics = {k: float(v) for k, v in step(state, frozen, batch).items()}
    residue = set()
    for by_net in grads.values():
        for net, gs in by_net.items():
            top = max(float(g.abs().max()) for g in gs.values())
            residue |= {f"{net}.{n}" for n, g in gs.items() if float(g.abs().max()) <= RESIDUE * top}
    # Residue everywhere it is, and only there, in each sub-step that trains the net.
    for by_net in grads.values():
        for net, gs in by_net.items():
            top = max(float(g.abs().max()) for g in gs.values())
            assert {f"{net}.{n}" for n, g in gs.items() if float(g.abs().max()) <= RESIDUE * top} <= residue
    return metrics, torch_ranks.gan_snapshot(state), grads, residue, cfg.train.lr


@pytest.mark.parametrize("remat", [False, True])
def test_sharded_gan_step_matches_one_process_at_f64(tmp_path, remat):
    cfg = torch_ranks.gan_cfg("float64")
    running = torch_ranks.Ranks("gan_step", 2, tmp_path, batch=torch_ranks.gan_batch(GAN_B, cfg), remat=remat)
    want, params, grads, residue, lr = gan_single()
    assert residue and all(k.endswith(".bias") and k.startswith("generator.") for k in residue), residue
    ranks = running.results()
    for r in ranks:
        assert r["metrics"].keys() == want.keys()
        for k, w in want.items():
            assert abs(r["metrics"][k] - w) <= REL * max(abs(w), 1e-3), (k, r["metrics"][k], w)
        assert r["grads"].keys() == grads.keys()
        for sub, by_net in grads.items():
            for net, gs in by_net.items():
                top = max(float(g.abs().max()) for g in gs.values())
                for n, g in gs.items():
                    d = float((r["grads"][sub][net][n] - g).abs().max())
                    assert d <= REL * top, (sub, net, n, d, top)
        _close_params(r["params"], params, residue, lr)
        assert r["traffic"]["all_reduce_grads"] > 0 and r["traffic"]["all_reduce_mean"] > 0
    # The ranks hold the same state bit for bit.
    assert all(torch.equal(ranks[0]["params"][k], ranks[1]["params"][k]) for k in params)
