"""torch's CPU thread pool for the port's heavy CPU tests."""

import contextlib

import torch


@contextlib.contextmanager
def one_torch_thread():
    """torch's CPU ops on one thread: under the suite's parallel workers its
    default thread pool, one thread a core in each worker, slows these
    small ops by tens of times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
