"""Device milliseconds a traced step of the kernels launched under
Optimizer.step (and zero_grad)."""

from benchmark.core import trace as T
from benchmark.core.readers import device_ms


def read(r):
    return device_ms(r, T.OPTIMIZER)
