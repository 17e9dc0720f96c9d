"""Median host milliseconds a batch spends in `data.h2d` inside the port's
`infer.predict` (`test_bp.predict`'s copy of the images from pageable
memory), over the batches called while the profiler was off. The copy
waits for the device's queue to drain first; a closed loop's queue is
empty by then, so here it reads close to the copy itself."""

from benchmark.core.program_spans import h2d_infer_ms as read  # noqa: F401
