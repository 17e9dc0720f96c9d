"""Device-side metric accumulation -- port of vaeplay_tpu/train/metrics.py.

A train step returns its metrics as 0-d tensors on the device. `accumulating`
adds them into running sums there, so that the host reads nothing while it
trains: `fetch_averages` copies the sums back once per log line, where the
reference's per-iteration `.item()` (train.py:81-85) waits for the device
every step.
"""

from typing import Callable, Dict, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from vaeplay_torch.parallel.mesh import all_mean
from vaeplay_torch.utils.profiling import span

Sums = Dict[str, torch.Tensor]


def accumulating(step_fn: Callable) -> Callable:
    """Wrap a (state, *args) -> (state, metrics) step into
    (state, acc, count, *args) -> (state, acc', count'), where acc' = acc +
    metrics on the device and count' = count + 1. Pass acc=None to start.
    The step and its adds are the span `train.step`."""

    def call(state, acc: Optional[Sums], count: int, *args) -> Tuple[object, Sums, int]:
        with span("train.step"):
            state, metrics = step_fn(state, *args)
            if acc is None:
                acc, count = {k: torch.zeros((), dtype=torch.float32, device=v.device)
                              for k, v in metrics.items()}, 0
            for k, v in metrics.items():
                acc[k] += v.detach().float()
        return state, acc, count + 1

    return call


def fetch_averages(acc: Sums, count: int, mesh: Optional[DeviceMesh] = None
                   ) -> Dict[str, float]:
    """One host sync: copy the sums back together and return their means.
    With a mesh every rank calls it, and the means are the global batch's
    (each rank's sums averaged over the "data" ranks first, the JAX
    package's fetch_averages of global arrays)."""
    keys = sorted(acc)
    sums = all_mean(torch.stack([acc[k] for k in keys]), mesh).cpu().tolist()
    n = max(int(count), 1)
    return {k: s / n for k, s in zip(keys, sums)}
