"""Torch on one CPU thread in the port's test modules.

Their CPU tests run thousands of small torch ops (training steps, EM and
Lloyd iterations, forwards) while other test processes run beside them. An
OpenMP team of 8 threads in each of 6 processes oversubscribes 8 cores, and
its barriers then wait on descheduled threads: on an 8-core CPU, 7 port
test files took 17 minutes in 6 processes with the default threads and
58 s with one. Each
port test module imports ``one_torch_thread`` (module-scoped, autouse),
which sets one thread for the module and restores the count after it.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_port_test_modules_run_torch_on_one_thread():
    assert torch.get_num_threads() == 1
