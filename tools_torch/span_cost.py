"""What the port's host spans (vaeplay_torch/utils/profiling.py) cost, on the
card's host:

    python3 -m tools_torch.span_cost [--steps 10] [--rounds 5] [--seed N]

from the repo root, on a machine with a CUDA card. It prints one JSON line
each for:

- `store`: microseconds a closed span costs with the profiler off (best of
  5 repeats of 200,000 spans), beside the profiler flag's check and a
  `record_function` entered with the profiler off; and under torch.profiler
  (CPU and CUDA activities, 5,000 spans), entering `record_function` and
  storing the record alone;
- `annotations`: the device-side copies of two nested spans under
  torch.profiler, with `is_user_annotation` (without it the benchmark's
  trace reduction would count them as busy device time);
- `traced`: `bp_train_bf16`'s loop body under torch.profiler, as the
  benchmark's `--trace 1` run traces it, with the spans entering
  `record_function` and with them storing records alone (the flag check
  patched off), in turns (with, without, without, with per round, after two
  windows discarded): the host `bench.step` and the traced window,
  milliseconds a step.
"""

import argparse
import json
import statistics
import time
import timeit

import torch
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

from vaeplay_torch.utils import profiling


def store_cost(n: int = 200_000) -> dict:
    def one_span():
        with profiling.span("train.step"):
            pass

    def one_range():
        with record_function("train.step"):
            pass

    best = lambda fn, k=n: min(timeit.repeat(fn, number=k, repeat=5)) / k * 1e6
    out = {"span_us": best(one_span), "flag_us": best(profiling._profiler_enabled),
           "record_function_off_us": best(one_range, n // 20)}
    out.update(profiled_span_cost())
    profiling.reset_spans()
    return out


def profiled_span_cost(n: int = 5000) -> dict:
    """Microseconds a span costs under torch.profiler, with its range and
    with the record alone."""
    real, out = profiling._profiler_enabled, {}
    for label, flag in (("profiled_with_range_us", real),
                        ("profiled_record_only_us", lambda: False)):
        profiling._profiler_enabled = flag
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                t = time.perf_counter()
                for _ in range(n):
                    with profiling.span("train.step"):
                        pass
                out[label] = (time.perf_counter() - t) / n * 1e6
        finally:
            profiling._profiler_enabled = real
    return out


def annotations(device: torch.device) -> list:
    x = torch.randn(1024, 1024, device=device)
    names = ("train.step", "train.forward")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with profiling.span(names[0]):
            with profiling.span(names[1]):
                (x @ x).sum()
        torch.cuda.synchronize(device)
    return [[e.name, e.device_type.name, getattr(e, "is_user_annotation", None)]
            for e in prof.events() if e.name in names]


def traced_step_ms(system, steps: int, device: torch.device) -> tuple:
    """(host bench.step, traced window) milliseconds a step over `steps`
    traced steps of the benchmark's loop body."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("bench.window"):
            torch.cuda.synchronize(device)
            for _ in range(steps):
                with record_function("bench.data"):
                    b = system.next_batch()
                with record_function("bench.copy"):
                    b = system.to_device(b)
                with record_function("bench.step"):
                    system.step(b)
            torch.cuda.synchronize(device)
    cpu = [e for e in prof.events() if e.device_type.name == "CPU"]
    step = sum(e.time_range.elapsed_us() for e in cpu if e.name == "bench.step")
    window = next(e for e in cpu if e.name == "bench.window").time_range.elapsed_us()
    return step / steps / 1e3, window / steps / 1e3


def traced_cost(steps: int, rounds: int, seed: int, device: torch.device) -> dict:
    from benchmark.core.manifest import find_cell
    from benchmark.drivers.common import modules

    cell = find_cell("bp_train_bf16")
    system_mod, ref_mod = modules(cell.config)
    system = system_mod.Trainer(cell.config, cell.traffic, seed, device,
                                ref_mod.weights(cell.config, seed, device))
    for _ in range(5):
        system.step(system.to_device(system.next_batch()))
    for n in (1, steps, steps):  # the tracer's start-up, then two windows discarded
        traced_step_ms(system, n, device)
    real, off = profiling._profiler_enabled, (lambda: False)
    out = {"with_ranges": [], "records_only": []}
    try:
        for label in ("with_ranges", "records_only", "records_only", "with_ranges") * rounds:
            profiling._profiler_enabled = real if label == "with_ranges" else off
            out[label].append(traced_step_ms(system, steps, device))
    finally:
        profiling._profiler_enabled = real
        system.close()
    for label in list(out):
        out[label + "_median"] = [statistics.median(x[i] for x in out[label]) for i in (0, 1)]
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--seed", type=int, default=20261018)
    args = parser.parse_args(argv)
    device = torch.device("cuda", 0)
    print(json.dumps({"store": store_cost()}), flush=True)
    print(json.dumps({"annotations": annotations(device)}), flush=True)
    print(json.dumps({"traced": traced_cost(args.steps, args.rounds, args.seed, device),
                      "card": torch.cuda.get_device_name(device)}), flush=True)


if __name__ == "__main__":
    main()
