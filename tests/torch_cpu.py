"""One CPU thread for every port test process and the processes it starts.

The suite runs in several pytest-xdist workers at once; with torch's
default of one intra-op thread per core, their tiny CPU ops spin against
each other and a test can run tens of times slower than alone.  Every
tests/test_torch_*.py imports this module first (tests/
test_torch_cpu_threads.py holds them to it).  It sets OMP_NUM_THREADS and
MKL_NUM_THREADS to 1 in os.environ, whatever they were, so that the CLIs,
torchrun ranks and eval workers the tests spawn inherit one thread, and
gives this process one intra-op thread.
"""

import os

for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"

import torch  # noqa: E402

torch.set_num_threads(1)
