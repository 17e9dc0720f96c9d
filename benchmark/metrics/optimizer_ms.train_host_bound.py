"""optimizer_ms.train in a cell that reports train_samples_per_s.host_bound."""

from benchmark.core import trace as T
from benchmark.core.readers import device_ms


def read(r):
    return device_ms(r, T.OPTIMIZER)
