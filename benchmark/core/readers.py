"""The arithmetic of the metric readers (benchmark/metrics/*.py), on a
core.record.RunRecord. A reader that finds nothing to read returns None,
and the run leaves that metric out of its line; a share of a roofline or of
a peak is never reported as 0 for want of a reading."""

from typing import Optional

import numpy as np

from benchmark.core import trace as T
from benchmark.core.peaks import PEAK_FLOPS


def rate(r) -> float:
    """Samples (or images) of all the window's steps over all of its time."""
    return r.window_steps * r.samples_per_step / r.window_s


def p95_ms(r) -> Optional[float]:
    return float(np.percentile(r.latencies_s, 95)) * 1e3 if r.latencies_s else None


def span_ms(r, name: str) -> Optional[float]:
    """Mean milliseconds a step of the benchmark's host span `name`."""
    spans = r.spans.get(name)
    return sum(spans) / len(spans) * 1e3 if spans else None


def device_ms(r, *groups: str) -> Optional[float]:
    """Device milliseconds a traced step of the trace groups named."""
    if r.trace is None or not r.traced_steps:
        return None
    s = r.trace.seconds(*groups)
    return s / r.traced_steps * 1e3 if s > 0 else None


def mfu_pct(r) -> Optional[float]:
    """Model FLOPs of the traced steps over the traced window, as a share of
    the peak of the cell's compute type."""
    if r.trace is None or not r.flops_per_step or r.trace.window_s <= 0 or r.trace.busy_s <= 0:
        return None
    return r.flops_per_step * r.traced_steps / r.trace.window_s / PEAK_FLOPS[r.compute_dtype] * 100


def attention_roofline_pct(r) -> Optional[float]:
    """The attention calls' one-pass bound over the attention kernel's device
    time, in the traced steps."""
    if r.trace is None or not r.attention_bound_s:
        return None
    s = r.trace.seconds(T.ATTN_FWD)
    return r.attention_bound_s * r.traced_steps / s * 100 if s > 0 else None


def idle_pct(r) -> Optional[float]:
    """The share of the traced window in which no operation ran on the
    device (busy time is the union of the device's activities)."""
    if r.trace is None or r.trace.window_s <= 0 or r.trace.busy_s <= 0:
        return None
    return (1.0 - r.trace.busy_s / r.trace.window_s) * 100
