"""What a run hands its metric readers."""

import dataclasses
from typing import Dict, List, Optional

from benchmark.core.trace import Trace


@dataclasses.dataclass
class RunRecord:
    """One run of a cell, as its readers (benchmark/metrics/*.py) see it.

    kind              "train" or "infer"
    compute_dtype     the cell's compute type ("float32", "bfloat16")
    samples_per_step  samples of a training step, images of a batch
    setup_s           process start to the window's first call
    window_s          the measured window, its first call to a synchronize
                      after its last
    window_steps      training steps or batches completed in it
    latencies_s       each batch's host-clock latency (inference)
    spans             the benchmark's own host spans in the window: name ->
                      each occurrence's seconds ("data": the wait for a
                      step's batch and its copy to the device)
    trace             the traced span's reduction (--trace 1), else None
    traced_steps      steps or batches in the traced span
    flops_per_step    model FLOPs of a step or batch, counted on the
                      reference (matmuls and convolutions, no recompute)
    attention_bound_s the one-pass attention bound of a step's or batch's
                      attention calls at the reference's shapes
    counters          the program's counters over the window, per step
    """

    kind: str
    compute_dtype: str
    samples_per_step: int
    setup_s: float
    window_s: float
    window_steps: int
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    trace: Optional[Trace] = None
    traced_steps: int = 0
    flops_per_step: Optional[float] = None
    attention_bound_s: Optional[float] = None
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
