"""Closed-loop training: the trainer's loop body back to back, as its CLI
runs it, with a loss fetch every `loss_fetch_every` steps.

Set-up builds the program's one step object from the seed's weights and
drives it through its first `compare_steps` steps with the loop's own feed
and call; those steps are the ones the reference follows, and they warm
every shape the loop uses (with the system's warm_up for what they may
not reach). The same object then runs the window: from the first step's
call until `--seconds` have passed, and to a synchronize after the last
step. The cell's rate is the samples of all the window's steps over all
of its time. The span "data" times the feed's next batch alone (the host's
synthesis and the wait on the prefetch thread); the copy to the card is
outside it, since a copy from pageable memory first waits for every kernel
still queued, which is device time and not the data layer's.
"""

import time

import torch
from torch.profiler import record_function

from benchmark.core.compare import train_numbers
from benchmark.core.peaks import attention_bound_s
from benchmark.core.record import RunRecord
from benchmark.drivers.common import (Outcome, attention_launches, by_quarter, free, memory_peak,
                                      modules, seconds_since, sync, traced)
from benchmark.reference.common import TrainRecord, norms


def _floats(tensors) -> dict:
    names = list(tensors)
    vals = torch.stack([tensors[k].detach().float() for k in names]).cpu().tolist()
    return dict(zip(names, vals))


def compared_steps(system, steps: int, device, phases: dict) -> TrainRecord:
    """Drive the program's step object through its first `steps` steps
    (batches 0, 1, ... of its feed, through its own call) and record each
    step's losses, every leaf's gradient as the optimizer got it first, the
    first step's model outputs, and every leaf's change after the steps."""
    theta0 = {k: p.detach().clone() for k, p in system.params().items()}
    losses = []
    with system.capture() as cap:
        for k in range(steps):
            t = time.perf_counter()
            system.reset_losses()
            system.step(system.to_device(system.next_batch()))
            losses.append(system.fetch())
            if k == 0:
                phases["first_step"] = seconds_since(t)
    update = _floats({k: (p.detach() - theta0[k]).norm() for k, p in system.params().items()})
    return TrainRecord(losses, norms(cap.first_grads), update, first_outputs=cap.first_outputs,
                       teacher=cap.answers or None, first_grad_tensors=cap.first_grads)


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device, t0: float) -> Outcome:
    cfg, traffic = cell.config, cell.traffic
    phases = {}
    system_mod, ref_mod = modules(cfg)
    phases["import"] = seconds_since(t0)
    t = time.perf_counter()
    system = system_mod.Trainer(cfg, traffic, seed, device, ref_mod.weights(cfg, seed, device))
    free(device)  # the benchmark's copy of the weights
    sync(device)
    phases["init"] = seconds_since(t)
    t = time.perf_counter()
    prog = compared_steps(system, traffic["compare_steps"], device, phases)
    phases["compared_steps"] = seconds_since(t)
    t = time.perf_counter()
    system.warm_up()
    sync(device)
    phases["warm_up"] = seconds_since(t)

    data_wait, issued = [], []
    launches0 = attention_launches()
    system.reset_losses()
    sync(device)
    start = time.perf_counter()
    setup_s = start - t0
    deadline = start + seconds
    steps = 0
    while True:
        a = time.perf_counter()
        batch = system.next_batch()
        data_wait.append(time.perf_counter() - a)
        batch = system.to_device(batch)
        system.step(batch)
        steps += 1
        issued.append(time.perf_counter() - start)
        if steps % traffic["loss_fetch_every"] == 0:
            system.fetch()
        if time.perf_counter() >= deadline:
            break
    sync(device)
    window_s = time.perf_counter() - start
    launches = (attention_launches() - launches0) / steps

    trace_result = None
    if trace:
        def one_step():
            with record_function("bench.data"):
                b = system.next_batch()
            with record_function("bench.copy"):
                b = system.to_device(b)
            with record_function("bench.step"):
                system.step(b)

        trace_result = traced(one_step, traffic["trace_steps"], device)
    peak = memory_peak(device)
    system.close()
    del system, batch
    free(device)

    t = time.perf_counter()
    ref = ref_mod.train(cfg, traffic, seed, device, "f32", traffic["compare_steps"],
                        teacher=prog.teacher, against=prog.first_grad_tensors)
    reference_s = seconds_since(t)
    dtype = traffic["compute_dtype"]
    record = RunRecord(
        kind="train", compute_dtype=dtype, samples_per_step=traffic["batch_size"],
        setup_s=setup_s, window_s=window_s, window_steps=steps, spans={"data": data_wait},
        trace=trace_result, traced_steps=traffic["trace_steps"], flops_per_step=ref.flops_per_step,
        attention_bound_s=(sum(attention_bound_s(s, dtype) for s in ref.attention_shapes)
                           if ref.attention_shapes else None),
        counters={"attention_launches_per_step": launches})
    return Outcome(record, train_numbers(prog, ref), attempted=steps, failed=0,
                   memory_peak_bytes=peak, setup_phases=phases, reference_s=reference_s,
                   notes=[f"[window] steps issued by quarter: {by_quarter(issued, window_s)}"])
