"""One intra-op thread for a block of CPU work, the caller's count restored
after, for tests that compare two CPU runs bit for bit: both then run the
same float32/float64 kernels in the same order, whatever else the machine
runs (``tests/test_torch_precision.py::test_cpu_night_ignores_the_fields``
once saw two such runs differ under the test workers' load).  Subprocesses
get the same through :data:`ENV`."""

import contextlib

import torch

#: the environment that gives a subprocess one thread
ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


@contextlib.contextmanager
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
