"""One run of one cell: its driver, its metric readers and the result line.

`run_cell` is what `run.py` calls once it has found the card; the CPU tests
call it directly at small sizes.
"""

import importlib
import json
import math
from typing import Dict, List, Tuple

import torch

from benchmark.core.compare import judge, uncompared
from benchmark.core.manifest import Cell, reader

BREAKDOWN_TOP = 10


def device_info(device: torch.device, chips: int, peak: int) -> Dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
                "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": peak}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             t0: float) -> Tuple[Dict, List[str]]:
    """(result, lines): the result object of the run's last output line and
    the lines for standard error, the compared numbers beside their limits
    last."""
    driver = importlib.import_module(f"benchmark.drivers.{cell.traffic['driver']}")
    out = driver.run(cell, seed, seconds, trace, device, t0)
    correct, compared = judge(out.numbers, cell.limits)
    metrics = {}
    for m in cell.metrics:
        if m.per_layer != trace:
            continue
        value = reader(m.name, cell.bench_dir)(out.record)
        if value is None:
            if not m.per_layer:
                raise RuntimeError(f"end-to-end metric {m.name} read nothing in {cell.name}")
            continue
        if not math.isfinite(value):
            raise RuntimeError(f"metric {m.name} read {value} in {cell.name}")
        metrics[m.name] = {"value": float(value), "unit": m.unit}
    info = device_info(device, cell.chips, out.memory_peak_bytes)
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": info}
    tr = out.record.trace
    if trace and tr is not None:
        info["busy_s"], info["window_s"] = tr.busy_s, tr.window_s
        ops = sorted(tr.groups.items(), key=lambda kv: -kv[1])[:BREAKDOWN_TOP]
        result["breakdown"] = {"device_ops": [[k, v] for k, v in ops],
                               "idle_gaps": [[k, v] for k, v in tr.idle_gaps[:BREAKDOWN_TOP]]}
    result["compared"] = compared
    phases = " ".join(f"{k} {v:.3f}" for k, v in out.setup_phases.items())
    lines = [f"[setup] {cell.name}: {out.record.setup_s:.3f} s to the window ({phases}); "
             f"reference check {out.reference_s:.3f} s",
             f"[memory] peak {out.memory_peak_bytes} bytes allocated on the fullest card",
             f"[window] {out.record.window_steps} steps in {out.record.window_s:.4f} s; "
             + json.dumps(out.record.counters), *out.notes]
    rest = uncompared(out.numbers, cell.limits)
    if rest:
        lines.append(f"[not compared] {json.dumps(rest)}")
    lines += [f"[compared] {k} {c['value']!r} limit {c['limit']!r}" for k, c in compared.items()]
    return result, lines
