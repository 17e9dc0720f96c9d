"""Device milliseconds a traced step of cuDNN's NCHW<->NHWC layout
transposes."""

from benchmark.core import trace as T
from benchmark.core.readers import device_ms


def read(r):
    return device_ms(r, T.LAYOUT)
