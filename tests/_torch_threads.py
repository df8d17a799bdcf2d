"""One torch intra-op thread for the port's test processes.

The suite runs several pytest-xdist workers on a few cores; with torch's
default (a thread per core) in every worker, the workers' thread pools
oversubscribe the cores and the port's small-shape tests spend their time
waiting for each other.  Every ``tests/test_torch_*.py`` and the helpers
they share import this module first.  JAX's and NumPy's own thread pools
are not touched.
"""
import torch

torch.set_num_threads(1)
