"""What the drivers share: synchronizing, the traced span, freeing the
program before the reference runs, and the outcome they hand back."""

import dataclasses
import gc
import importlib
import time
from typing import Callable, Dict, List, Optional

import torch

from benchmark.core.record import RunRecord
from benchmark.core.trace import Trace, reduce_profile

WINDOW_SPAN = "bench.window"


@dataclasses.dataclass
class Outcome:
    """A driver's run: the record its metrics read, the numbers compared
    with the reference, the operations attempted and failed in the window,
    the device's peak memory (read before the reference ran), set-up by
    phase and the reference's seconds (reported on earlier output lines)."""

    record: RunRecord
    numbers: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    setup_phases: Dict[str, float]
    reference_s: float
    notes: List[str] = dataclasses.field(default_factory=list)


def modules(cfg: dict):
    """(system, reference) modules of a configuration's model."""
    return (importlib.import_module(f"benchmark.systems.{cfg['system']}"),
            importlib.import_module(f"benchmark.reference.{cfg['system']}"))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def traced(run_one: Callable[[], None], steps: int, device: torch.device) -> Trace:
    """Trace `steps` calls of run_one under torch.profiler, inside the host
    span WINDOW_SPAN that ends after a synchronize, after one traced call of
    its own that pays the tracer's start-up."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    for n in (1, steps):
        with profile(activities=activities) as prof:
            with record_function(WINDOW_SPAN):
                sync(device)
                for _ in range(n):
                    run_one()
                sync(device)
    return reduce_profile(prof, WINDOW_SPAN)


def free(device: torch.device) -> None:
    """Return the program's freed memory before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def seconds_since(t: float) -> float:
    return time.perf_counter() - t


def by_quarter(times, window_s: float) -> List[int]:
    """How many of `times` (seconds into the window) fall in each quarter of
    it: whether a slow run was slow throughout or in a stretch."""
    counts = [0, 0, 0, 0]
    for t in times:
        counts[min(3, int(4 * t / window_s))] += 1
    return counts


def attention_launches() -> Optional[int]:
    """The port's attention kernel launches so far (its own counter)."""
    from vaeplay_torch.ops import attention

    return attention.flash_attention.launches
