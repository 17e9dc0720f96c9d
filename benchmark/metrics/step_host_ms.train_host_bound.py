"""step_host_ms.train in a cell that reports train_samples_per_s.host_bound."""

from benchmark.core.program_spans import step_host_ms as read  # noqa: F401
