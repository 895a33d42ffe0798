"""The one-thread rule of the port's tests, in one place.

Every tests/test_torch_*.py takes it by one import:

    from torch_threads import one_thread  # noqa: F401

pytest then finds the module-scoped autouse fixture in the test module's
namespace. This is a plain module, not a conftest, so that the card's
`--noconftest -m cuda` run gets it too; it imports no JAX.
"""

import pytest
import torch


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One intra-op torch thread: these tests run many small torch ops,
    which threads do not speed up, and the suite runs its files in
    parallel workers that would otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
