"""The comparison that decides `correct`: numbers read from the program's
run against the plain reference's. A cell's limits file
(benchmark/limits/<cell>.json) names the numbers it holds to a limit; the
others are reported beside them. Training: train_numbers. Inference:
output_gap, the widest |output - reference's| over the largest |reference
output| of its tensor, over every output of the calls judged. A leaf whose
gradient is under MOVED_SHARE of the median leaf's at every optimizer step
moves under Adam by round-off alone and is left out of the change numbers.
"""

import math
import statistics
from typing import Dict, Iterable, List, Mapping, Tuple

MOVED_SHARE = 1e-3
NOT_FINITE = 1e30  # a gap that is NaN or infinite, as a JSON number


def _finite(x: float) -> float:
    return x if math.isfinite(x) else NOT_FINITE


def _gap(a: float, b: float, scale: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return NOT_FINITE
    if scale <= 0:
        return 0.0 if a == b else NOT_FINITE
    return abs(a - b) / scale


def moved_leaves(grad_norms: Iterable[Mapping[str, float]]) -> List[str]:
    """The leaves whose gradient reaches MOVED_SHARE of the median leaf's
    at some optimizer step."""
    moved = {}
    for g in grad_norms:
        med = statistics.median(g.values())
        for k, v in g.items():
            moved[k] = moved.get(k, False) or v >= MOVED_SHARE * med
    return [k for k, m in moved.items() if m]


def train_numbers(prog, ref) -> Dict[str, float]:
    """The program's TrainRecord against the reference's:
      loss_gap          the first step's losses before its first update;
      loss_gap_later    every step's losses;
      output_gap        the first step's model outputs (output_gap);
      grad_gap          the worst leaf's gap of first-gradient norms;
      grad_diff         the worst leaf's norm of the first gradient's
                        difference from the reference's (ref.first_grad_diff),
                        over the reference's norm of that leaf or of the
                        median leaf;
      grad_diff_median  the same of the median leaf;
      update_gap        the worst moved leaf's gap of change norms;
      update_median     the median moved leaf's gap of change norms."""
    out = {}
    if len(prog.losses) != len(ref.losses):
        out["loss_gap"] = out["loss_gap_later"] = NOT_FINITE
    else:
        p0, r0 = prog.losses[0], ref.losses[0]
        out["loss_gap"] = max(_gap(p0.get(k, math.nan), r0[k], abs(r0[k])) for k in ref.pre_update)
        out["loss_gap_later"] = max(_gap(p.get(k, math.nan), r[k], abs(r[k]))
                                    for p, r in zip(prog.losses, ref.losses) for k in r)
    out["output_gap"] = output_gap(prog.first_outputs or {}, ref.first_outputs)
    med = statistics.median(ref.first_grad.values())
    out["grad_gap"] = max(_gap(prog.first_grad.get(k, math.nan), v, max(v, med))
                          for k, v in ref.first_grad.items())
    if ref.first_grad_diff is not None:
        diffs = [_gap(ref.first_grad_diff.get(k, math.nan), 0.0, max(v, med))
                 for k, v in ref.first_grad.items()]
        out["grad_diff"], out["grad_diff_median"] = max(diffs), statistics.median(diffs)
    moved = moved_leaves(ref.grad_norms)
    med_u = statistics.median(ref.update[k] for k in moved)
    ups = [_gap(prog.update.get(k, math.nan), ref.update[k], max(ref.update[k], med_u))
           for k in moved]
    out["update_gap"], out["update_median"] = max(ups), statistics.median(ups)
    return out


def output_gap(prog: Mapping, ref: Mapping) -> float:
    """The widest gap of one call's outputs (dicts of tensors) against the
    reference's, each over its tensor's largest reference magnitude."""
    worst = 0.0
    for k, r in ref.items():
        p = prog.get(k)
        if p is None or tuple(p.shape) != tuple(r.shape):
            return NOT_FINITE
        scale = float(r.abs().max())
        diff = float((p.to(r.device).float() - r.float()).abs().max())
        worst = max(worst, _gap(diff, 0.0, scale) if math.isfinite(diff) else NOT_FINITE)
    return worst


def judge(numbers: Mapping[str, float], limits: Mapping[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit; a number without one is reported by the caller apart."""
    compared = {k: {"value": _finite(numbers[k]), "limit": float(limits[k])} for k in limits}
    return all(c["value"] <= c["limit"] for c in compared.values()), compared


def uncompared(numbers: Mapping[str, float], limits: Mapping[str, float]
               ) -> Dict[str, float]:
    return {k: _finite(v) for k, v in numbers.items() if k not in limits}


def train_detail(prog, ref) -> dict:
    """Every leaf's readings behind train_numbers: [leaf, program's first
    gradient norm, reference's, norm of their difference, program's change
    norm, reference's, share of the first gradient's elements whose sign
    differs], and each step's losses on both sides."""
    leaves = [[k, prog.first_grad.get(k), v, (ref.first_grad_diff or {}).get(k),
               prog.update.get(k), ref.update.get(k), (ref.first_grad_flips or {}).get(k)]
              for k, v in ref.first_grad.items()]
    return {"leaves": leaves, "moved": moved_leaves(ref.grad_norms),
            "losses": [prog.losses, ref.losses]}
