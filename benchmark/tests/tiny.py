"""Cells of BENCHMARK.json at sizes a CPU test holds: the same models,
traffic and limits, with the configuration cut by its tiny preset and the
traffic by its driver's.

A configuration's preset is `tests/tiny/<config>.json`, found by the
configuration's name: the keys of its file that a CPU test cuts (the image,
the widths of a pyramid), with their tiny values.
"""

import copy
import json
import time
from pathlib import Path

import torch

from benchmark.core.manifest import ROOT, find_cell, load_manifest
from benchmark.harness import run_cell

TINY_DIR = Path(__file__).resolve().parent / "tiny"
TINY_TRAFFIC = {"train_loop": {"batch_size": 4, "epoch_iterations": 50, "trace_steps": 2,
                               "loss_fetch_every": 2},
                "infer_closed_loop": {"batch_size": 2, "pool_batches": 3, "sample_calls": 3,
                                      "sample_range": 6, "trace_steps": 2}}


def tiny_preset(config: str) -> dict:
    """The tiny values of configuration `config`'s cut keys; raises
    FileNotFoundError, naming the file, where it has no preset."""
    path = TINY_DIR / f"{config}.json"
    if not path.is_file():
        raise FileNotFoundError(f"configuration {config!r} has no tiny preset: "
                                f"{path.relative_to(ROOT)} is missing")
    return json.loads(path.read_text())


def tiny_cell(name: str):
    cell = copy.deepcopy(find_cell(name))
    config = next(w["config"] for w in load_manifest()["workloads"] if w["name"] == name)
    cell.config.update(tiny_preset(config))
    cell.traffic.update(TINY_TRAFFIC[cell.traffic["driver"]])
    return cell


def run_tiny(name: str, seed: int = 123456789012, seconds: float = 0.5, trace: bool = False,
             cell=None):
    cell = cell or tiny_cell(name)
    return run_cell(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter())
