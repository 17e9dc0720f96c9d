"""Faults planted underneath the harness, to see `correct` come out false.

One module a system, `tests/faults/<system>.py`, found by the system's
name. It offers FAULTS, {driver: the faults it plants in that driver's
cells}, and plant(monkeypatch, cell, fault), where `cell` is a tiny cell
(tests/tiny.py). A state left unchanged (Adam's step does nothing) is
planted here, in every training cell.
"""

import importlib
from pathlib import Path
from typing import List

import torch

GENERIC = {"train_loop": ("state_unchanged",)}


def path_of(system: str) -> Path:
    return Path(__file__).resolve().parent / f"{system}.py"


def module_of(system: str):
    """tests/faults/<system>.py, or None where the system has none."""
    if not path_of(system).is_file():
        return None
    return importlib.import_module(f"{__name__}.{system}")


def faults_of(cell) -> List[str]:
    """The faults planted in a cell: its driver's generic ones, then its
    system's own."""
    driver = cell.traffic["driver"]
    own = module_of(cell.config["system"])
    return [*GENERIC.get(driver, ()), *(own.FAULTS.get(driver, ()) if own else ())]


def plant(monkeypatch, cell, fault: str) -> None:
    """Break the program's timed path underneath the harness."""
    if fault == "state_unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    else:
        module_of(cell.config["system"]).plant(monkeypatch, cell, fault)


def half_rows(*tensors):
    return [t[: t.shape[0] // 2] for t in tensors]


def swap(t):
    return torch.cat([t[:-1], t[:1]]) if t.dim() > 1 and t.shape[0] > 1 else t
