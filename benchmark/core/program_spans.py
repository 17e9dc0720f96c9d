"""The port's own host spans (`vaeplay_torch/utils/profiling.py`: `spans()`),
grouped by step for the `program_span` metrics.

A training step is a `train.step` record with the `data.h2d` and
`data.feed` records that ended after the previous step's ended; an
inference batch is an `infer.predict` record with its children. A metric is
the median over the steps (batches) in which no record was taken while
torch.profiler recorded: in a `--trace 1` run, the untraced window, which is
the loop of a `--trace 0` run, with the few compared and warm-up steps
outvoted. Where the store holds none of such a step, a metric reads None.
So does every metric where the program keeps no store at all: the
benchmark's files may be laid over a checkout of the port from before the
store (to compare the two on the same cells), and there they leave these
metrics out of the line instead of failing the run.
"""

import statistics
from typing import Callable, List, Optional

from vaeplay_torch.utils import profiling

Step = List  # the step's records, its train.step (infer.predict) first


def records() -> Optional[list]:
    """The port's span store, oldest first, or None where it keeps none."""
    read = getattr(profiling, "spans", None)
    return read() if read is not None else None


def ms(rec) -> float:
    return (rec.end_ns - rec.start_ns) / 1e6


def total_ms(step: Step, name: str, parent: Optional[str] = None) -> float:
    """Milliseconds of the step's records named `name` (under `parent`, if
    given)."""
    return sum(ms(r) for r in step if r.name == name and (parent is None or r.parent == parent))


def _grouped(recs, head: str, belongs: Callable) -> List[Step]:
    steps, pending = [], []
    for r in recs:
        if r.name == head:
            step, pending = [r, *pending], []
            if not any(x.profiled for x in step):
                steps.append(step)
        elif belongs(r):
            pending.append(r)
    return steps


def train_steps(recs) -> List[Step]:
    return _grouped(recs, "train.step", lambda r: r.name in ("data.h2d", "data.feed"))


def infer_batches(recs) -> List[Step]:
    return _grouped(recs, "infer.predict", lambda r: r.parent == "infer.predict")


def median_ms(group: Callable[[list], List[Step]],
              measure: Callable[[Step], Optional[float]]) -> Optional[float]:
    """The median of `measure` over the untraced steps that `group` finds in
    the store, leaving out steps it reads None in."""
    recs = records()
    if not recs:
        return None
    values = [v for v in map(measure, group(recs)) if v is not None]
    return statistics.median(values) if values else None


def feed_self_ms(step: Step) -> Optional[float]:
    """The step's `data.feed` less its `data.h2d` children; None without a
    feed span."""
    if not any(r.name == "data.feed" for r in step):
        return None
    return total_ms(step, "data.feed") - total_ms(step, "data.h2d", parent="data.feed")


# the readers (benchmark/metrics/*.py); each takes the run's RunRecord and
# reads the store instead

def h2d_train_ms(r) -> Optional[float]:
    return median_ms(train_steps, lambda step: total_ms(step, "data.h2d"))


def h2d_infer_ms(r) -> Optional[float]:
    return median_ms(infer_batches, lambda batch: total_ms(batch, "data.h2d"))


def step_host_ms(r) -> Optional[float]:
    return median_ms(train_steps, lambda step: total_ms(step, "train.step"))


def feed_host_ms(r) -> Optional[float]:
    return median_ms(train_steps, feed_self_ms)
