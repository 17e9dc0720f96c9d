"""data_wait_ms.train in a cell that reports train_samples_per_s.host_bound."""

from benchmark.core.readers import span_ms


def read(r):
    return span_ms(r, "data")
