"""Cells of BENCHMARK.json at sizes a CPU test holds: the same models,
traffic and limits, with the image, the pyramid's widths and the batch cut."""

import copy
import time

import torch

from benchmark.core.manifest import find_cell
from benchmark.harness import run_cell

TINY_CONFIG = {
    "bp_512": {"image_size": 64,
               "emit_channels": [[16, 2], [32, 2], [64, 2], [64, 2], [64, 2], [64, 1], [64, 1]]},
    "style_gan_256": {"image_size": 32, "z_dim": 16},
}
TINY_TRAFFIC = {"train_loop": {"batch_size": 4, "epoch_iterations": 50, "trace_steps": 2,
                               "loss_fetch_every": 2},
                "infer_closed_loop": {"batch_size": 2, "pool_batches": 3, "sample_calls": 3,
                                      "sample_range": 6, "trace_steps": 2}}


def tiny_cell(name: str):
    cell = copy.deepcopy(find_cell(name))
    system = cell.config["system"]
    key = {"bp": "bp_512", "style_gan": "style_gan_256"}[system]
    cell.config.update(TINY_CONFIG[key])
    cell.traffic.update(TINY_TRAFFIC[cell.traffic["driver"]])
    return cell


def run_tiny(name: str, seed: int = 123456789012, seconds: float = 0.5, trace: bool = False,
             cell=None):
    cell = cell or tiny_cell(name)
    return run_cell(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter())
