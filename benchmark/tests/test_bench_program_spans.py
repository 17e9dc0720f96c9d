"""The `program_span` metrics: each reads nothing from an empty store or a
port without one, a finite number from a tiny traced run, and only the
steps taken while the profiler was off."""

import math
import time

import pytest

from benchmark.core import program_spans as S
from benchmark.core.manifest import load_manifest, reader
from benchmark.core.record import RunRecord
from benchmark.tests.tiny import run_tiny, tiny_cell
from vaeplay_torch.utils import profiling

MANIFEST = load_manifest()
PROGRAM = {m["name"]: m["workloads"] for m in MANIFEST["per_layer"]
           if m["source"] == "program_span"}
CELLS = sorted({c for cells in PROGRAM.values() for c in cells})
EMPTY = RunRecord(kind="train", compute_dtype="float32", samples_per_step=8, setup_s=1.0,
                  window_s=1.0, window_steps=1)
PLANTED_MS = 30.0


@pytest.fixture(autouse=True)
def empty_store():
    profiling.reset_spans()
    yield
    profiling.reset_spans()


def test_every_cell_has_a_program_span_metric():
    assert set(CELLS) == {w["name"] for w in MANIFEST["workloads"]}


@pytest.mark.parametrize("metric", sorted(PROGRAM))
def test_a_reader_of_an_empty_store_reads_nothing(metric):
    assert reader(metric)(EMPTY) is None


@pytest.mark.parametrize("metric", sorted(PROGRAM))
def test_a_port_without_the_store_reads_nothing(metric, monkeypatch):
    """A checkout of the port from before the store: the metric is left out,
    the run does not fail."""
    with profiling.span("train.step"):
        pass
    monkeypatch.delattr(profiling, "spans")
    assert reader(metric)(EMPTY) is None


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_every_program_span_metric(cell):
    result, lines = run_tiny(cell, trace=True)
    assert result["correct"], lines
    for name in (m for m, cells in PROGRAM.items() if cell in cells):
        value = result["metrics"][name]["value"]
        assert math.isfinite(value) and value >= 0, name


def _plant(monkeypatch) -> None:
    """Every span that opens while the profiler records lasts PLANTED_MS
    longer."""
    real = profiling.span.__exit__

    def slow_exit(self, kind, value, tb):
        if self.range is not None:
            time.sleep(PLANTED_MS / 1e3)
        real(self, kind, value, tb)

    monkeypatch.setattr(profiling.span, "__exit__", slow_exit)


@pytest.mark.parametrize("cell,head,traced", [("bp_train_f32", "train.step", 8),
                                              ("bp_infer_f32", "infer.predict", 40)])
def test_the_traced_steps_move_no_median(cell, head, traced, monkeypatch):
    """More traced steps than untraced ones, each span in them slow: the
    medians read the untraced steps alone."""
    _plant(monkeypatch)
    c = tiny_cell(cell)
    c.traffic["trace_steps"] = traced
    result, lines = run_tiny(cell, seconds=0.1, trace=True, cell=c)
    assert result["correct"], lines
    recs = profiling.spans()
    heads = [r.profiled for r in recs if r.name == head]
    assert sum(heads) > len(heads) - sum(heads) > 0
    assert all(S.ms(r) >= PLANTED_MS for r in recs if r.profiled)
    untraced = [r for r in recs if not r.profiled]
    monkeypatch.setattr(profiling, "spans", lambda: untraced)
    for name in (m for m, cells in PROGRAM.items() if cell in cells):
        assert result["metrics"][name]["value"] == reader(name)(EMPTY), name
