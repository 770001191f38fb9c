"""One intra-op torch thread per test module of the port.

The suite runs in several pytest-xdist workers on one host. Each torch op
on a tensor above torch's parallel grain opens a parallel region over all
of the host's cores, so with six workers each runs six times as many
threads as cores, and their barriers dominate: six concurrent copies of
tests/test_torch_render.py's Sponza oracle test, 11 s alone, took over
900 s with the default threads and 19 s with one thread each. The port's
CPU route is its kernels' plain versions: many small ops, for which one
thread loses little.

A test module imports `one_torch_thread` (autouse, module scope); it
restores the previous thread count when the module ends.
"""

import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
