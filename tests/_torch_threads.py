"""The port's test modules run torch at two intra-op threads.

The suite runs six files at once on the CPU, and more threads in each
worker only oversubscribe the shared cores. A module takes the fixture by
importing it by name (`from _torch_threads import _two_threads`): pytest
then applies it, autouse, to that module alone.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads while the module runs; the previous count comes
    back after it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
