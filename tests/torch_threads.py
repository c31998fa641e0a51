"""The port's CPU tests run torch with two intra-op threads.

The suite runs six workers on the CPU's cores, and torch's default of one
thread a core in each of them leaves the small-op graphs of these tests
waiting on each other's threads (a view step that takes seconds alone
took minutes beside five busy workers).  Every tests/test_torch_*.py
imports this fixture, which is module-scoped and autouse, so it applies to
the whole file and restores the count afterwards.  It imports neither JAX
nor the JAX package, so the card's tests can take it too."""

import pytest


@pytest.fixture(scope="module", autouse=True)
def _few_torch_threads():
    import torch

    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)
