"""``portbench/tests/test_portbench_reference.py``, collected here so that the
repository's test run (``tests/``) runs the benchmark's own tests too."""

import pytest
import torch

from portbench.tests.test_portbench_reference import *  # noqa: F401,F403


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two intra-op torch threads: the parallel test workers share the
    host's cores, and the rehearsals' nets would take them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
