"""One thread a pool for every process that runs a port test file.

The tier-1 run spreads the test files over several worker processes on
one machine.  torch's intra-op pool and the two OpenBLAS libraries (numpy's
and scipy's) each start one thread a core in every worker, which
oversubscribes the cores many times over: a port test then runs many times
slower than alone.  The port's tests run small batches, where one thread
loses nothing.  Every ``tests/test_torch_*.py`` imports this module first;
pytest does not collect it (its name does not start with ``test_``).
``torch.set_num_interop_threads`` is left alone: it raises once inter-op
work has started in the process.
"""
import scipy.linalg  # noqa: F401  (loads scipy's BLAS, so the cap reaches it)
import torch

torch.set_num_threads(1)
try:
    from threadpoolctl import threadpool_limits
except ImportError:        # a machine without it runs the files one by one
    pass
else:
    threadpool_limits(1)   # numpy's and scipy's OpenBLAS, torch's OpenMP
