"""Median host milliseconds a step spends in the port's `data.feed` span
less its `data.h2d` children (self time): the feed's table synthesis, sort
and render for one batch, without its pageable copies. Over the steps taken
while the profiler was off; None in a feed without the span."""

from benchmark.core.program_spans import feed_host_ms as read  # noqa: F401
