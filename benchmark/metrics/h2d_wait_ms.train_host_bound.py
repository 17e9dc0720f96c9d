"""h2d_wait_ms.train in a cell that reports train_samples_per_s.host_bound."""

from benchmark.core.program_spans import h2d_train_ms as read  # noqa: F401
