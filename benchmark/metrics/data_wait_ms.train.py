"""Mean host milliseconds a step waits for its batch: the benchmark's span
around the feed's next batch (host synthesis and the prefetch wait), over
the window. The benchmark's copy to the card is outside it: a pageable copy
waits for the device's queue to drain, which would make this read device
time. A feed that copies to the card itself (Style_GAN's device_batches
copies each bubble table and its labels from pageable memory) has that
wait inside the span, and only a span inside the program can split it."""

from benchmark.core.readers import span_ms


def read(r):
    return span_ms(r, "data")
