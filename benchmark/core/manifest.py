"""Finding a cell's parts by name.

`BENCHMARK.json` at the checkout's root names the cells, configurations and
metrics. A cell's configuration is the JSON file its `configs` entry names;
its traffic mix is `benchmark/traffic/<traffic>.json`; the limits of its
comparison are `benchmark/limits/<cell>.json`; every metric is read by
`benchmark/metrics/<metric>.py`. A later cell, configuration or metric is
new files and new manifest entries: nothing here names one.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    per_layer: bool


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with everything it names loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    metrics: List[Metric]  # the cell's end-to-end and per-layer metrics, in manifest order
    bench_dir: Path = BENCH_DIR  # where its traffic, limits and metric readers were found


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_metrics(manifest: dict, cell: str) -> List[Metric]:
    """The end-to-end metrics the cell reports (those listing it, or with no
    list), then the per-layer ones that list it."""
    e2e = [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]
    per_layer = [m for m in manifest["per_layer"] if cell in m["workloads"]]
    return ([Metric(m["name"], m["unit"], False) for m in e2e]
            + [Metric(m["name"], m["unit"], True) for m in per_layer])


def find_cell(name: str, root: Path = ROOT, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell `name` of root/BENCHMARK.json; raises KeyError for an
    unknown name and FileNotFoundError for a missing part."""
    manifest = load_manifest(root)
    work = {w["name"]: w for w in manifest["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has {sorted(work)}")
    w = work[name]
    config = next(c for c in manifest["configs"] if c["name"] == w["config"])
    return Cell(name=name, chips=int(w["chips"]), config=_read_json(root / config["file"]),
                traffic=_read_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
                limits=_read_json(bench_dir / "limits" / f"{name}.json"),
                metrics=cell_metrics(manifest, name), bench_dir=bench_dir)


def reader(metric: str, bench_dir: Path = BENCH_DIR) -> Callable:
    """The `read(record)` function of benchmark/metrics/<metric>.py."""
    path = bench_dir / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{metric.replace('.', '_')}",
                                                  path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader for metric {metric!r} at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
