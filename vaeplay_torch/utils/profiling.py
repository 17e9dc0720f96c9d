"""Tracing and step timing -- port of vaeplay_tpu/utils/profiling.py (the
reference has none).

  with maybe_profile("/tmp/trace"):
      ... training loop ...

writes a `torch.profiler` trace (host ops and, where there is a card, its
kernels) into the directory, readable by TensorBoard's profiler plugin or
chrome://tracing. StepTimer keeps a host-side window of lap times without
forcing device syncs: call .lap() after a host sync point, such as a
metric fetch.
"""

import contextlib
import time
from collections import deque
from typing import Optional

import torch


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str]):
    """A torch.profiler trace into trace_dir over the block; nothing when
    trace_dir is empty."""
    if not trace_dir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(trace_dir)) as prof:
        yield prof


class StepTimer:
    """Items per second over the last WINDOW laps; each lap() closes one
    (call it where the host has synced with the device, or the time is the
    enqueue's)."""

    WINDOW = 50

    def __init__(self):
        self._laps = deque(maxlen=self.WINDOW)
        self._t = time.perf_counter()

    def lap(self, n_items: int = 1) -> None:
        now = time.perf_counter()
        self._laps.append((now - self._t, n_items))
        self._t = now

    @property
    def items_per_sec(self) -> float:
        dt = sum(d for d, _ in self._laps)
        return sum(n for _, n in self._laps) / dt if dt > 0 else 0.0
