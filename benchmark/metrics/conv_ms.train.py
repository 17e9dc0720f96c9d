"""Device milliseconds a traced step of convolution forward, dgrad and
wgrad, transposed convolutions included (their layout transposes apart)."""

from benchmark.core import trace as T
from benchmark.core.readers import device_ms


def read(r):
    return device_ms(r, *T.CONV_GROUPS)
