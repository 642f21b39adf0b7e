"""A cap on torch's threads for one test module.

The lane runs six test processes (`-n 6`) on the host's cores, each with
XLA's own thread pool beside torch's.  torch takes a thread a core by
default, and its idle threads spin: tiny-model tests ran 11-60x slower
there than alone, and a full-width step starved the other processes
(`test_torch_port_train_fullwidth.py` read 206 s alone and 1254 s in the
lane).  With every port module capped, the lane's test-seconds fell from
8243 to 4761 on one host.  A module assigns `few_torch_threads(n)` to a
name of its own (1 at the tiny configs, 2 at full width), and its tests
run with at most n threads.
"""

import pytest
import torch


def few_torch_threads(n: int):
    """An autouse module fixture that caps torch's threads at `n` and
    gives back the count it found."""
    @pytest.fixture(scope="module", autouse=True)
    def _few_torch_threads():
        old = torch.get_num_threads()
        torch.set_num_threads(min(old, n))
        yield
        torch.set_num_threads(old)
    return _few_torch_threads
