"""One caller in a closed loop: each batch's call, then a synchronize, then
the next call, cycling through a pool of batches that set-up makes from the
seed. A batch's latency is the host clock from the call to the
synchronize after it, the host-to-device copy included.

The answers judged are those of `sample_calls` calls drawn from the seed
among the first `sample_range`, and of the window's last call: after the
window the reference computes each again from the same images and compares.
"""

import contextlib
import itertools
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.core.compare import output_gap
from benchmark.core.peaks import attention_bound_s
from benchmark.core.record import RunRecord
from benchmark.drivers.common import (Outcome, attention_launches, by_quarter, free, memory_peak,
                                      modules, seconds_since, sync, traced)
from benchmark.reference.common import Ops, flop_counter


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, t0: float) -> Outcome:
    cfg, traffic = cell.config, cell.traffic
    phases = {}
    system_mod, ref_mod = modules(cfg)
    phases["import"] = seconds_since(t0)
    t = time.perf_counter()
    pool = ref_mod.inference_pool(cfg, traffic, seed)
    server = system_mod.Server(cfg, traffic, seed, device, ref_mod.weights(cfg, seed, device))
    free(device)  # the benchmark's copy of the weights
    sync(device)
    phases["init"] = seconds_since(t)
    t = time.perf_counter()
    for i in range(traffic["warmup_calls"]):
        server(pool[i % len(pool)])
        sync(device)
    phases["warm_up"] = seconds_since(t)

    keep = set(np.random.default_rng(seed).choice(traffic["sample_range"], traffic["sample_calls"],
                                                  replace=False).tolist())
    kept, latencies = {}, []
    launches0 = attention_launches()
    sync(device)
    start = time.perf_counter()
    setup_s = start - t0
    deadline = start + seconds
    n = 0
    while True:
        imgs = pool[n % len(pool)]
        a = time.perf_counter()
        out = server(imgs)
        sync(device)
        now = time.perf_counter()
        latencies.append(now - a)
        if n in keep:
            kept[n] = out
        n += 1
        if now >= deadline:
            break
    window_s = time.perf_counter() - start
    kept[n - 1] = out
    launches = (attention_launches() - launches0) / n

    trace_result = None
    if trace:
        calls = iter(range(10 ** 9))

        def one_call():
            with record_function("bench.call"):
                server(pool[next(calls) % len(pool)])
                sync(device)

        trace_result = traced(one_call, traffic["trace_steps"], device)
    peak = memory_peak(device)
    teachers = {i: server.teacher(o) for i, o in kept.items()}
    server.close()
    del server, out
    free(device)

    t = time.perf_counter()
    weights, ops = ref_mod.weights(cfg, seed, device), Ops("f32")
    gaps, flops = {}, None
    for i in sorted(kept):
        counter = flop_counter() if flops is None else contextlib.nullcontext()
        with counter:
            ref = ref_mod.infer(cfg, weights, pool[i % len(pool)], device, ops, teachers[i])
        if flops is None:
            flops, shapes = counter.get_total_flops(), list(ops.attention_shapes)
        gaps[i] = output_gap(kept[i], ref)
    reference_s = seconds_since(t)
    limit = cell.limits.get("output_gap", float("inf"))
    dtype = traffic["compute_dtype"]
    record = RunRecord(
        kind="infer", compute_dtype=dtype, samples_per_step=traffic["batch_size"],
        setup_s=setup_s, window_s=window_s, window_steps=n, latencies_s=latencies,
        trace=trace_result, traced_steps=traffic["trace_steps"], flops_per_step=flops,
        attention_bound_s=sum(attention_bound_s(s, dtype) for s in shapes) if shapes else None,
        counters={"attention_launches_per_step": launches})
    return Outcome(record, {"output_gap": max(gaps.values())}, attempted=n,
                   failed=sum(g > limit for g in gaps.values()), memory_peak_bytes=peak,
                   setup_phases=phases, reference_s=reference_s,
                   notes=[f"[answers] judged: {len(gaps)} calls",
                          f"[window] calls by quarter: "
                          f"{by_quarter(itertools.accumulate(latencies), window_s)}"])
