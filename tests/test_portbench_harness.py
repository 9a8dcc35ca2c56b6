"""``portbench/tests/test_portbench_harness.py``, collected here so that the
repository's test run (``tests/``) runs the benchmark's own tests too."""

import functools

import pytest
import torch

from portbench.tests import test_portbench_harness as harness
from portbench.tests.test_portbench_harness import *  # noqa: F401,F403

# Not collected here: it expects ``run.forbidden_modules()``, which is
# sorted, in ``run.FORBIDDEN``'s order, which holds only while flax is not
# loaded, and a worker of this run may have loaded it for another file.
# It runs in ``portbench/tests``, where nothing loads JAX.
del test_forbidden_names_are_compared_whole  # noqa: F821


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op torch threads: the parallel test workers share the
    host's cores, and the rehearsals' nets would take them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def several_batches(request, monkeypatch):
    """A longer window for the de-id faults planted in the program, in the
    closed-loop cells: the rehearsal's first batch shows neither (a 0.01 s
    window reads ``share_far`` 0 under the half-batch skip mean), and
    where the parallel test workers load the host a 1.5 s window may hold
    just that batch.  (The open loop keeps its window: a longer one only
    piles up its queue.)"""
    if request.function.__name__ not in ("test_an_altered_answer_fails", "test_a_skip_mean_over_half_the_batch_fails"):
        return
    _, _, mix = harness.run.cell_files(harness.REHEARSED, request.node.callspec.params["workload"])
    if mix.get("loop") == "closed":
        monkeypatch.setattr(harness, "rehearse", functools.partial(harness.rehearse, seconds=6.0))
