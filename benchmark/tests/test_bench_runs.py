"""Whole runs of every cell on the CPU at small sizes: correct as they stand,
not correct with the timed path broken underneath or with the control (the
reference one precision down) in the program's place, and never with JAX
or the JAX package loaded."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark.control import infer_readings, train_readings
from benchmark.core.compare import judge
from benchmark.core.manifest import BENCH_DIR, ROOT, find_cell, load_manifest
from benchmark.tests import faults
from benchmark.tests.tiny import run_tiny, tiny_cell

CELLS = [w["name"] for w in load_manifest()["workloads"]]
FOUND = {c: find_cell(c) for c in CELLS}
TRAIN = [c for c in CELLS if FOUND[c].traffic["driver"] == "train_loop"]
SYSTEMS = {}  # each system of the manifest: its first cell
for _cell in CELLS:
    SYSTEMS.setdefault(FOUND[_cell].config["system"], _cell)
CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_runs_and_is_correct(cell):
    result, lines = run_tiny(cell)
    assert result["correct"], lines
    assert list(result)[-1] == "compared" and lines[-1].startswith("[compared]")
    e2e = {m.name for m in tiny_cell(cell).metrics if not m.per_layer}
    assert set(result["metrics"]) == e2e
    assert all(v["value"] > 0 for v in result["metrics"].values())


def test_a_traced_run_reports_per_layer_metrics_only():
    result, _ = run_tiny("bp_train_bf16", trace=True)
    per_layer = {m.name for m in tiny_cell("bp_train_bf16").metrics if m.per_layer}
    assert set(result["metrics"]) <= per_layer
    assert "data_wait_ms.train_host_bound" in result["metrics"]
    assert "window_s" in result["device"] and "breakdown" in result


FAULTS = [(c, f) for c in TRAIN + [c for c in CELLS if c not in TRAIN]
          for f in faults.faults_of(FOUND[c])]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_has_faults_of_its_own(cell):
    """A cell's limits never run without faults planted by its system's
    file: tests/faults/<system>.py, with faults for the cell's driver."""
    c = FOUND[cell]
    system, driver = c.config["system"], c.traffic["driver"]
    path = faults.path_of(system).relative_to(ROOT)
    own = faults.module_of(system)
    assert own is not None, f"system {system!r} of {cell} has no planted faults: {path} is missing"
    assert own.FAULTS.get(driver), f"{path} plants no fault in {driver} cells such as {cell}"


@pytest.mark.parametrize("cell, fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    c = tiny_cell(cell)
    faults.plant(monkeypatch, c, fault)
    result, lines = run_tiny(cell, cell=c)
    assert not result["correct"], lines


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    """The reference one precision below the cell's (fp8 for bf16, bf16 for
    f32) in the program's place fails one of the cell's limits."""
    c = tiny_cell(cell)
    readings = train_readings if cell in TRAIN else infer_readings
    numbers = readings(c, "control", 5, CPU)
    correct, compared = judge(numbers, c.limits)
    assert not correct, compared


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """One tiny cell of every system of the manifest, in one process."""
    code = ("import sys; from benchmark.tests.tiny import run_tiny; from benchmark.run import "
            f"forbidden_modules; [run_tiny(c) for c in {list(SYSTEMS.values())!r}]; "
            "print(forbidden_modules(), sorted({m.split('.')[0] for m in sys.modules} & "
            "{'vaeplay_torch'}))")
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] ['vaeplay_torch']"


def test_the_reference_imports_nothing_of_the_port():
    banned = {"vaeplay_torch", "vaeplay_tpu", "jax", "jaxlib", "flax"}
    for path in (BENCH_DIR / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not {n.split(".")[0] for n in names} & banned, (path.name, names)
    names = sorted(p.stem for p in (BENCH_DIR / "reference").glob("*.py")
                   if p.stem != "__init__")
    missing = sorted(set(SYSTEMS) - set(names))
    assert not missing, [f"benchmark/reference/{s}.py is missing" for s in missing]
    code = ("import importlib, sys; "
            f"[importlib.import_module('benchmark.reference.' + n) for n in {names!r}]; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'vaeplay_torch', 'vaeplay_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]


def test_without_a_card_a_run_prints_no_result_and_fails():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "bp_train_bf16",
                          "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_with_only_the_benchmark_a_run_prints_no_result_and_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "bp_infer_f32",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_on_the_card(cell):
    """A short run of each cell at its own size, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark.harness import run_cell

    result, lines = run_cell(find_cell(cell), 2 ** 31 + 11, 2.0, False, torch.device("cuda", 0),
                             0.0)
    assert result["correct"], json.dumps(result["compared"])
