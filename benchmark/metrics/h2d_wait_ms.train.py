"""Median host milliseconds a training step spends in the port's `data.h2d`
spans: each copy of its batch from pageable memory (BP's `to_device`;
Style_GAN's bubble tables and labels inside `data.feed`). Such a copy first
waits for the device's queue to drain, so in a step whose device work
outlasts the host's issue this reads mostly that wait: it falls when device
time falls, and a copy that does not block would move the wait to the next
blocking point rather than remove it. Over the steps taken while the
profiler was off (`core/program_spans.py`)."""

from benchmark.core.program_spans import h2d_train_ms as read  # noqa: F401
