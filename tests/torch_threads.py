"""An autouse fixture for the port's test modules: one torch thread a test.

The suite runs in several worker processes at once, and torch's default of
one thread a core oversubscribes the cores many times over. A module takes
it with ``from torch_threads import one_torch_thread  # noqa: F401``."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
