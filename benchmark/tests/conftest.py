"""One intra-op thread a test process: the tests run the cells at small
sizes, where threads buy little, and under several pytest-xdist workers
OpenMP's spinning threads would contend for the cores."""

import torch

torch.set_num_threads(1)
