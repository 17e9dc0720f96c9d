"""Reduction of a torch.profiler trace to what the per-layer metrics read.

`group` attributes a device activity to the layer that launched it, from
the kernel's name and the chain of host ops around its launch (innermost
first): the attention kernel, the attention's autograd backward, the
optimizer, cuDNN's layout transposes, convolutions, norms, copies.
`reduce_profile` sums device seconds by group over a traced window, takes
the device's busy time as the union of its activities' intervals (a sum
would count overlapping activities twice), and names the longest idle gaps
by what the host was doing in them.
"""

import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

ATTN_FWD = "attention kernel (forward)"
ATTN_BWD = "attention backward"
OPTIMIZER = "optimizer step"
LAYOUT = "cuDNN NCHW<->NHWC transposes"
CONV_FWD = "convolution forward"
CONV_BWD = "convolution dgrad/wgrad"
CONVT_FWD = "conv-transpose forward"
CONVT_BWD = "conv-transpose dgrad/wgrad"
H2D = "host-to-device copy"
D2H = "device-to-host copy"
COPIES = "tensor copies and casts"
CONV_GROUPS = (CONV_FWD, CONV_BWD, CONVT_FWD, CONVT_BWD)

_CONV_OPS = ("aten::conv2d", "aten::convolution", "aten::_convolution", "aten::cudnn_convolution")
_CONVT_OPS = ("aten::conv_transpose2d", "aten::cudnn_convolution_transpose")
_COPY_OPS = ("aten::copy_", "aten::_to_copy", "aten::to", "aten::clone", "aten::contiguous")
SPAN_PREFIX = "bench."  # the benchmark's own host spans (torch.profiler.record_function)


def group(kernel: str, ops: Sequence[str], transposed: bool = False) -> str:
    """The group of a device activity named `kernel`, launched under the
    host ops `ops` (innermost first); `transposed`: it runs in the backward
    of a transposed convolution."""
    node = next((o.rsplit(": ", 1)[-1] for o in ops
                 if o.startswith("autograd::engine::evaluate_function")), "")
    inner = ops[0] if ops else ""
    # the node before the kernel's name: a kernel the attention's backward
    # launches is backward time, whatever it is called
    if node.startswith("SpatialAttention"):
        return ATTN_BWD
    if "flash_attention" in kernel and not any(t in kernel for t in ("bwd", "backward")):
        return ATTN_FWD
    if "Memcpy" in kernel:
        return D2H if "DtoH" in kernel else (H2D if "HtoD" in kernel else COPIES)
    if any(o.startswith("Optimizer.") for o in ops):
        return OPTIMIZER
    if any(t in kernel for t in ("nchwToNhwc", "nhwcToNchw")):
        return LAYOUT
    if inner in _COPY_OPS:
        return COPIES
    if node.startswith(("CudnnBatchNormBackward", "NativeBatchNormBackward")):
        return "BatchNorm / InstanceNorm, backward"
    if "aten::instance_norm" in ops or "aten::batch_norm" in ops:
        return "BatchNorm / InstanceNorm, forward"
    if node.startswith(("ConvolutionBackward", "CudnnConvolutionBackward")):
        return CONVT_BWD if transposed else CONV_BWD
    if any(o in _CONVT_OPS for o in ops):
        return CONVT_FWD
    if any(o in _CONV_OPS for o in ops):
        return CONV_FWD
    if "gemm" in kernel or any(o in ("aten::mm", "aten::addmm", "aten::bmm", "aten::linear")
                               for o in ops):
        return "GEMMs (linear layers, bmm)" + (", backward" if node else "")
    if node.startswith("GridSampler") or any(o.startswith("aten::grid_sampler") for o in ops):
        return "point sampling (grid_sample)" + (", backward" if node else "")
    return "elementwise and other" + (", backward" if node else "")


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The intervals merged where they overlap or touch, in order."""
    merged: List[List[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(s, e) for s, e in merged]


def clip(intervals: Iterable[Tuple[float, float]], start: float, end: float):
    return [(max(s, start), min(e, end)) for s, e in intervals if e > start and s < end]


def busy(intervals: Iterable[Tuple[float, float]], start: float, end: float) -> float:
    """Length of the union of the intervals within [start, end]."""
    return sum(e - s for s, e in union(clip(intervals, start, end)))


def gaps(intervals: Iterable[Tuple[float, float]], start: float, end: float
         ) -> List[Tuple[float, float]]:
    """The stretches of [start, end] that no interval covers."""
    out, t = [], start
    for s, e in union(clip(intervals, start, end)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if end > t:
        out.append((t, end))
    return out


@dataclasses.dataclass
class Trace:
    """A traced window: its length and the device's busy seconds in it,
    device seconds by group, and the longest idle gaps as (what the host was
    doing, seconds), longest first."""

    window_s: float
    busy_s: float
    groups: Dict[str, float]
    idle_gaps: List[Tuple[str, float]]

    def seconds(self, *names: str) -> float:
        return sum(self.groups.get(n, 0.0) for n in names)


@dataclasses.dataclass
class HostOp:
    name: str
    start: float
    end: float


def label_gap(ops: Sequence[HostOp], t: float, window: str) -> str:
    """What the host was doing at time t: the outermost benchmark span and
    the innermost op around t, from ops on the host thread."""
    around = [o for o in ops if o.start <= t < o.end and o.name != window]
    if not around:
        return "(no host op)"
    spans = [o for o in around if o.name.startswith(SPAN_PREFIX)]
    inner = min(around, key=lambda o: o.end - o.start)
    outer = max(spans, key=lambda o: o.end - o.start).name if spans else ""
    return inner.name if not outer or outer == inner.name else f"{outer} > {inner.name}"


def reduce_profile(prof, window: str, top: int = 10) -> Trace:
    """The Trace of `prof` (a finished torch.profiler.profile with CPU and
    CUDA activities) over the host span named `window`, which must enclose
    the traced work and end after a device synchronize."""
    events = prof.events()
    span = next(e for e in events if e.name == window and e.device_type.name == "CPU")
    start, end = span.time_range.start, span.time_range.end  # microseconds
    device, groups = [], {}
    transposed_seq = {e.sequence_nr for e in events
                      if e.name == "aten::conv_transpose2d" and e.sequence_nr >= 0}
    for e in events:
        if e.device_type.name == "CUDA":
            if not getattr(e, "is_user_annotation", False) and not e.name.startswith(SPAN_PREFIX):
                device.append((e.time_range.start, e.time_range.end))
            continue
        # "Command Buffer Full" is the tracer's span for a launch that waited
        # on a full launch queue: its kernels are the launching op's as well
        if not e.kernels or e.name == "Command Buffer Full":
            continue
        ops, parent, transposed = [], e, False
        while parent is not None:
            ops.append(parent.name)
            if parent.name.startswith("autograd::engine::evaluate_function"):
                transposed = parent.sequence_nr in transposed_seq
            parent = parent.cpu_parent
        for k in e.kernels:
            if k.name != e.name:  # a user range's own span on the device
                g = group(k.name, ops, transposed)
                groups[g] = groups.get(g, 0.0) + k.duration / 1e6
    host = [HostOp(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.device_type.name == "CPU" and e.thread == span.thread]
    idle = sorted(gaps(device, start, end), key=lambda g: g[0] - g[1])[:top]
    return Trace(window_s=(end - start) / 1e6, busy_s=busy(device, start, end) / 1e6,
                 groups=groups,
                 idle_gaps=[(label_gap(host, (s + e) / 2, window), (e - s) / 1e6)
                            for s, e in idle])
