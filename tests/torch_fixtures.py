"""Fixtures shared by the port's CPU tests (tests/test_torch_*.py).

`one_torch_thread`: the port's tests push tiny tensors through thousands of
small PyTorch ops. With PyTorch's default of one intra-op thread per core,
each op waits until all its threads are scheduled; when the suite runs in
several worker processes on a loaded machine that wait dominates (the
DeepSeek engine test took 0.8 s alone and ~300 s beside four other test
files). One thread for the module keeps each op on the calling thread; the
count is restored after the module. A module takes the fixture with
`from torch_fixtures import one_torch_thread  # noqa: F401`.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
