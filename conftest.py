"""Test-run settings that hold for every test directory.

Under pytest-xdist each worker is a process of its own, and torch's
intra-op pool defaults to one thread a core: n workers would run n
threads a core and spend their time switching between them.  A worker
(``PYTEST_XDIST_WORKER`` set) therefore takes its share of the cores,
``max(1, os.cpu_count() // PYTEST_XDIST_WORKER_COUNT)`` threads, before
any test module imports torch; ``OMP_NUM_THREADS`` and
``MKL_NUM_THREADS``, where unset, carry the same share to the processes
a test spawns.  A run in one process (the card's test runs) keeps
torch's default.  ``XLA_FLAGS`` is left alone (``tests/conftest.py``).
"""
import os


def worker_threads() -> int | None:
    """The intra-op threads of this xdist worker, or None outside one."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return None
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, os.cpu_count() // workers)


_threads = worker_threads()
if _threads is not None:
    for _name in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(_name, str(_threads))
    try:
        import torch
    except ImportError:   # the torch-less run of the reference's tests
        pass
    else:
        torch.set_num_threads(_threads)
