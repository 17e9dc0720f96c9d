"""The manifest and the files it names: every part is found by name, the
manifest keeps to the benchmark's contract, and a configuration, a cell and
a per-layer metric are added as new files and new entries alone."""

import hashlib
import json
import re
import shutil

import pytest
import torch

from benchmark.core.manifest import BENCH_DIR, ROOT, find_cell, load_manifest, reader
from benchmark.core.record import RunRecord
from benchmark.drivers.common import modules
from benchmark.harness import run_cell
from benchmark.tests.tiny import TINY_CONFIG, TINY_TRAFFIC

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
    config.update(TINY_CONFIG["bp_512"])
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
