"""Device milliseconds a traced step of the kernels run by the attention's
autograd backward (SpatialAttention's backward node)."""

from benchmark.core import trace as T
from benchmark.core.readers import device_ms


def read(r):
    return device_ms(r, T.ATTN_BWD)
