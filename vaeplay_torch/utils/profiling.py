"""Tracing and step timing -- port of vaeplay_tpu/utils/profiling.py (the
reference has none).

  with span("train.step"):
      ...

records one host span when the block closes: its name, the innermost span
open around it on the same thread (its parent), its start and end from
`time.perf_counter_ns()`, and whether torch.profiler was recording when it
opened. The records go into one bounded ring (SPAN_RING records; the oldest
fall off), read by `spans()` and emptied by `reset_spans()`. While
torch.profiler records, a span also opens `record_function(name)`, so the
program's names lie on the profiler's timeline beside the kernels they
launch; otherwise it enters none (one costs about 10 us even with the
profiler off). Names are `<layer>.<what>`: `train.step`, `train.forward`,
`data.h2d`, ...

  with maybe_profile("/tmp/trace"):
      ... training loop ...

writes a `torch.profiler` trace (host ops and, where there is a card, its
kernels) into the directory, readable by TensorBoard's profiler plugin or
chrome://tracing. StepTimer keeps a host-side window of lap times without
forcing device syncs: call .lap() after a host sync point, such as a
metric fetch.
"""

import contextlib
import threading
import time
from collections import deque
from typing import List, NamedTuple, Optional

import torch
from torch.autograd.profiler import record_function

SPAN_RING = 65536  # records the store keeps; a long run holds a fixed amount

_profiler_enabled = torch._C._autograd._profiler_enabled
_clock = time.perf_counter_ns
_ring: deque = deque(maxlen=SPAN_RING)


class Span(NamedTuple):
    """One closed span: `parent` is the name of the innermost span that was
    open around it on its thread (None at the top); times are
    perf_counter_ns(); `profiled`: torch.profiler was recording when it
    opened."""

    name: str
    parent: Optional[str]
    start_ns: int
    end_ns: int
    profiled: bool


class _Open(threading.local):
    name: Optional[str] = None  # the innermost open span on this thread


_open = _Open()


class span:
    """A host span around a `with` block (see the module's docstring): two
    clock reads, a flag check and one append to the store, plus a
    record_function while torch.profiler records."""

    __slots__ = ("name", "parent", "start", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        self.parent = _open.name
        _open.name = self.name
        self.range = record_function(self.name).__enter__() if _profiler_enabled() else None
        self.start = _clock()

    def __exit__(self, kind, value, tb) -> None:
        end = _clock()
        if self.range is not None:
            self.range.__exit__(kind, value, tb)
        _open.name = self.parent
        _ring.append((self.name, self.parent, self.start, end, self.range is not None))


def spans() -> List[Span]:
    """The store's records, oldest first, as they closed; reading clears
    nothing."""
    return [Span(*r) for r in list(_ring)]


def reset_spans() -> None:
    _ring.clear()


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
