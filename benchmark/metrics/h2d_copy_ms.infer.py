"""Device milliseconds a traced batch of host-to-device copies (the images,
from pageable memory)."""

from benchmark.core import trace as T
from benchmark.core.readers import device_ms


def read(r):
    return device_ms(r, T.H2D)
