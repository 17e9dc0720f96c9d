"""The manifest and the files it names: every part is found by name, the
manifest keeps to the benchmark's contract, and a configuration, a cell, a
per-layer metric and a model are added as new files and new entries alone."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET

import pytest
import torch

from benchmark.core.manifest import BENCH_DIR, ROOT, find_cell, load_manifest, reader
from benchmark.core.record import RunRecord
from benchmark.drivers.common import modules
from benchmark.harness import run_cell
from benchmark.tests.tiny import TINY_TRAFFIC, tiny_preset

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MANIFEST = load_manifest()


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_every_part_of_a_cell_is_found_by_name(cell):
    c = find_cell(cell)
    system, reference = modules(c.config)
    assert hasattr(reference, "param_specs") and hasattr(reference, "weights")
    assert hasattr(system, "Trainer" if c.traffic["driver"] == "train_loop" else "Server")
    assert (BENCH_DIR / "drivers" / f"{c.traffic['driver']}.py").is_file()
    assert c.limits and all(v > 0 for v in c.limits.values())
    for m in c.metrics:
        assert callable(reader(m.name))


def test_the_manifest_keeps_to_the_contract():
    m = MANIFEST
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert m["command"][:3] == ["python3", "-m", "benchmark.run"] and m["paths"] == ["benchmark"]
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    used = {w["config"] for w in m["workloads"]}
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert c["name"] in used and c["reduced"] == []
    pairs = set()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["chips"] == 1 and len(w["why"]) <= 200 and (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for e in m["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(e["unit"]) and e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25 and e["better"] in ("lower", "higher")
    names = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in m["workloads"]}
    for p in m["per_layer"]:
        assert set(p) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(p["name"]) and UNIT.match(p["unit"]) and p["moves"] in e2e
        for cell in p["workloads"]:
            assert cell in cells and cell in e2e[p["moves"]].get("workloads", [cell])
    for cell in cells:  # each cell reports setup_s, one more end-to-end and one per-layer metric
        ms = find_cell(cell).metrics
        assert sum(not x.per_layer for x in ms) >= 2 and any(x.per_layer for x in ms)
    assert len(json.dumps(m)) < 64 * 1024


def _digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_config_cell_and_metric_are_new_files_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "benchmark"
    before = _digests(bench)

    config = json.loads((bench / "configs" / "bp_512.json").read_text())
    config.update(tiny_preset("bp_512"))
    (bench / "configs" / "bp_tiny.json").write_text(json.dumps(config))
    traffic = json.loads((bench / "traffic" / "train_b8_f32.json").read_text())
    traffic.update(TINY_TRAFFIC["train_loop"])
    (bench / "traffic" / "train_tiny_f32.json").write_text(json.dumps(traffic))
    (bench / "limits" / "bp_tiny_train.json").write_text(json.dumps({"loss_gap": 1e-4}))
    (bench / "metrics" / "window_steps.train.py").write_text(
        "def read(r):\n    return r.window_steps\n")
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "bp_tiny", "source": "a test", "reduced": [],
                                "file": "benchmark/configs/bp_tiny.json", "why": "a test"})
    manifest["workloads"].append({"name": "bp_tiny_train", "config": "bp_tiny",
                                  "traffic": "train_tiny_f32", "chips": 1, "why": "a test"})
    manifest["per_layer"].append({"name": "window_steps.train", "unit": "steps",
                                  "better": "higher", "source": "host_clock", "layer": "data",
                                  "moves": "train_samples_per_s",
                                  "workloads": ["bp_tiny_train"]})
    manifest["end_to_end"][0]["workloads"].append("bp_tiny_train")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = find_cell("bp_tiny_train", root=tmp_path, bench_dir=bench)
    assert cell.config["image_size"] == 64 and cell.limits == {"loss_gap": 1e-4}
    assert [m.name for m in cell.metrics if m.per_layer] == ["window_steps.train"]
    result, _ = run_cell(cell, 7, 0.2, True, torch.device("cpu"), 0.0)
    assert result["correct"] and result["metrics"]["window_steps.train"]["value"] >= 1
    after = _digests(bench)
    assert {p: d for p, d in after.items() if p in before} == before  # nothing edited


def test_a_reader_finds_nothing_and_says_so():
    empty = RunRecord(kind="train", compute_dtype="bfloat16", samples_per_step=8, setup_s=1.0,
                      window_s=1.0, window_steps=1)
    for m in MANIFEST["per_layer"]:
        if m["source"] == "device_trace":
            assert reader(m["name"])(empty) is None, m["name"]


# The files a toy model brings (a two-layer perceptron), laid out as they sit
# under benchmark/; nothing imports them from there.
TOY_FILES = BENCH_DIR / "tests" / "toy_model"
TOY = "toy_train"


def _with_toy(root, leave_out=()):
    """Lay the toy model's files, less `leave_out`, into the benchmark copied
    to `root`, and add its manifest entries; the digests of the copy's files
    before."""
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    bench = root / "benchmark"
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(bench)
    for src in TOY_FILES.rglob("*"):
        rel = src.relative_to(TOY_FILES)
        if not src.is_file() or "__pycache__" in rel.parts or rel.as_posix() in leave_out:
            continue
        assert not (bench / rel).exists(), f"{rel} is not a new file"
        (bench / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(src, bench / rel)
    manifest = load_manifest(root)
    manifest["configs"].append({"name": "toy", "source": "a test", "reduced": [],
                                "file": "benchmark/configs/toy.json", "why": "a test"})
    manifest["workloads"].append({"name": TOY, "config": "toy", "traffic": "train_toy_f32",
                                  "chips": 1, "why": "a test"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if m["name"] in ("train_samples_per_s", "data_wait_ms.train"):
            m["workloads"].append(TOY)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return before


def _pytest_in(root, cases):
    """Run the copy's own tests `cases` (ids under benchmark/tests) in a
    process that finds the copy's `benchmark` package first; each case's
    outcome and failure text, by id."""
    junit = root / "junit.xml"
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    env["PYTHONPATH"] = os.pathsep.join([str(root), str(ROOT), env.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                          f"--junitxml={junit}", *(f"benchmark/tests/{c}" for c in cases)],
                         cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert junit.is_file(), out.stdout[-3000:] + out.stderr[-3000:]
    outcomes = {}
    for case in ET.parse(junit).getroot().iter("testcase"):
        bad = next((e for e in case if e.tag in ("failure", "error")), None)
        skipped = case.find("skipped") is not None
        outcomes[f"{case.get('classname').split('.')[-1]}.py::{case.get('name')}"] = (
            "skipped" if skipped else "passed" if bad is None else "failed",
            "" if bad is None else f"{bad.get('message', '')} {bad.text or ''}")
    return outcomes


def test_a_new_model_is_new_files_alone(tmp_path):
    """A toy model's system, reference, configuration, traffic, limits, tiny
    preset and planted faults, and its manifest entries: in a copy, the
    benchmark's own tests find every part by name, run it correct, see a
    planted fault and the control fail, and import its reference without the
    port; no file of the benchmark is edited."""
    before = _with_toy(tmp_path)
    runs = "test_bench_runs.py::"
    cases = [f"test_bench_manifest.py::test_every_part_of_a_cell_is_found_by_name[{TOY}]",
             "test_bench_manifest.py::test_the_manifest_keeps_to_the_contract",
             f"{runs}test_a_cell_runs_and_is_correct[{TOY}]",
             f"{runs}test_every_cell_has_faults_of_its_own[{TOY}]",
             *(f"{runs}test_a_broken_timed_path_is_not_correct[{TOY}-{f}]"
               for f in ("state_unchanged", "half_batch", "row_swapped")),
             f"{runs}test_the_control_is_not_correct[{TOY}]",
             f"{runs}test_the_reference_imports_nothing_of_the_port"]
    outcomes = _pytest_in(tmp_path, cases)
    assert outcomes == {c: ("passed", "") for c in cases}, outcomes
    after = _digests(tmp_path / "benchmark")
    assert {p: d for p, d in after.items() if p in before} == before  # nothing edited


def test_a_model_without_its_test_files_fails_by_name(tmp_path):
    """The toy model without its tiny preset and its planted faults: the
    benchmark's tests still collect, and the cases that need those files
    fail, naming them; the others pass."""
    preset, planted = "tests/tiny/toy.json", "tests/faults/toy.py"
    _with_toy(tmp_path, leave_out=(preset, planted))
    runs = "test_bench_runs.py::"
    expect = {f"test_bench_manifest.py::test_every_part_of_a_cell_is_found_by_name[{TOY}]": None,
              f"{runs}test_every_cell_has_faults_of_its_own[bp_train_bf16]": None,
              f"{runs}test_every_cell_has_faults_of_its_own[{TOY}]": planted,
              f"{runs}test_a_cell_runs_and_is_correct[{TOY}]": preset,
              f"{runs}test_a_broken_timed_path_is_not_correct[{TOY}-state_unchanged]": preset,
              f"{runs}test_the_control_is_not_correct[{TOY}]": preset}
    outcomes = _pytest_in(tmp_path, list(expect))
    assert set(outcomes) == set(expect), outcomes
    for case, missing in expect.items():
        status, text = outcomes[case]
        if missing is None:
            assert status == "passed", (case, text)
        else:
            assert status == "failed" and f"benchmark/{missing}" in text, (case, text)
