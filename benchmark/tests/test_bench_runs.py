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
from benchmark.core.manifest import BENCH_DIR, ROOT, load_manifest
from benchmark.tests.tiny import run_tiny, tiny_cell

CELLS = [w["name"] for w in load_manifest()["workloads"]]
TRAIN = [c for c in CELLS if tiny_cell(c).traffic["driver"] == "train_loop"]
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


def _half_rows(*tensors):
    return [t[: t.shape[0] // 2] for t in tensors]


def _swap(t):
    return torch.cat([t[:-1], t[:1]]) if t.dim() > 1 and t.shape[0] > 1 else t


def plant(monkeypatch, cell: str, fault: str) -> None:
    """Break the program's timed path underneath the harness."""
    import vaeplay_torch.cli.train_style_gan as sg_cli
    import vaeplay_torch.models.bp as bp_model
    import vaeplay_torch.train.steps_bp as steps_bp
    import vaeplay_torch.train.steps_style_gan as steps_sg

    if fault == "state_unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    elif fault == "half_batch" and cell.startswith("bp_train"):
        for name in ("loss_phase1", "loss_phase2"):
            real = getattr(steps_bp, name)
            monkeypatch.setattr(steps_bp, name, lambda m, i, a, b, d, real=real:
                                real(m, *_half_rows(i, a, b), d))
    elif fault == "half_batch" and cell.startswith("style_gan"):
        real = sg_cli.render_batch
        monkeypatch.setattr(sg_cli, "render_batch", lambda *a: (
            lambda xt, xc, lab, split: (*_half_rows(xt, xc, lab), None))(*real(*a)))
    elif fault == "row_swapped" and cell.startswith("bp_train"):
        real = steps_bp._f32
        monkeypatch.setattr(steps_bp, "_f32",
                            lambda preds: {k: _swap(v) for k, v in real(preds).items()})
    elif fault == "row_swapped" and cell.startswith("style_gan"):
        monkeypatch.setattr(steps_sg, "_widen", lambda t: _swap(t.float()))
    elif cell.startswith("bp_infer"):
        real = bp_model.ComposeNet.forward
        if fault == "half_batch":
            forward = lambda self, x: {k: torch.cat([v, v])[: x.shape[0]]
                                       for k, v in real(self, x[: x.shape[0] // 2]).items()}
        else:
            forward = lambda self, x: {k: _swap(v) for k, v in real(self, x).items()}
        monkeypatch.setattr(bp_model.ComposeNet, "forward", forward)
    else:
        raise ValueError((cell, fault))


FAULTS = ([(c, f) for c in TRAIN for f in ("state_unchanged", "half_batch", "row_swapped")]
          + [("bp_infer_f32", f) for f in ("half_batch", "row_swapped")])


@pytest.mark.parametrize("cell, fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    plant(monkeypatch, cell, fault)
    result, lines = run_tiny(cell)
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
    code = ("import sys; from benchmark.tests.tiny import run_tiny; from benchmark.run import "
            "forbidden_modules; run_tiny('bp_train_bf16'); run_tiny('style_gan_train_bf16'); "
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
    code = ("import sys, benchmark.reference.bp, benchmark.reference.style_gan; "
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
    from benchmark.core.manifest import find_cell
    from benchmark.harness import run_cell

    result, lines = run_cell(find_cell(cell), 2 ** 31 + 11, 2.0, False, torch.device("cuda", 0),
                             0.0)
    assert result["correct"], json.dumps(result["compared"])
