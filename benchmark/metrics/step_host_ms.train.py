"""Median host milliseconds of the port's `train.step` span (the step and
its metric adds under `accumulating`): issuing the forward, waiting while
autograd's thread issues the backward, and the optimizer. Over the steps
taken while the profiler was off (`core/program_spans.py`)."""

from benchmark.core.program_spans import step_host_ms as read  # noqa: F401
