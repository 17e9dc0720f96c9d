"""The readings a cell's limits are set from (not part of a benchmark run).

    python3 -m benchmark.control --workload <cell> --program-seeds 1 2 ... \
        --control-seeds 7 8 9 [--fault-seeds 7 8 9] [--witness-seeds ...] \
        [--nudged-seeds ...] [--steps 1 3] [--out chiprun_out/readings.jsonl]

In one process, at the cell's own sizes, on the card:
  program  the program's compared steps (training) or answers to the pool's
           batches (inference) against the f32 reference: the lower reading;
  control  the reference in the nearest precision below the cell's
           (reference.common.CONTROL), put in the program's place: the upper;
  faults   the f32 reference with a planted fault in the program's place:
           half of each batch left out (the mean over the rest), and one
           image's answers replaced by another's where they are produced
           ("row_swapped"). A state left unchanged reads 1 on update_median
           by its definition and needs no run;
  witness  (training, --witness-seeds) the reference in --witness-precision
           (bf16 by default; f32_default: f32 under PyTorch's default flags,
           as a float32 cell's program runs) put in the program's place:
           what that arithmetic alone reads;
  nudged   (training, --nudged-seeds) the f32 reference started from its
           weights one ulp up, in the program's place: what round-off
           alone reads, in any precision.
Training readings follow `--steps` steps (the cell's compare_steps by
default), each count in turn. Each reading is one JSON line: {"kind",
"seed", "steps", numbers...}.
"""

import argparse
import json
import sys
import time
from typing import Optional

import torch

from benchmark.core.compare import output_gap, train_detail, train_numbers
from benchmark.core.manifest import find_cell
from benchmark.drivers.common import free, modules
from benchmark.drivers.train_loop import compared_steps
from benchmark.reference.common import CONTROL, Ops

FAULTS = ("half_batch", "row_swapped")


def train_readings(cell, kind: str, seed: int, device, steps: Optional[int] = None) -> dict:
    cfg, traffic = cell.config, cell.traffic
    system_mod, ref_mod = modules(cfg)
    steps = steps or traffic["compare_steps"]
    if kind == "program":
        system = system_mod.Trainer(cfg, traffic, seed, device, ref_mod.weights(cfg, seed, device))
        run = compared_steps(system, steps, device, {})
        system.close()
        del system
    elif kind == "control":
        run = ref_mod.train(cfg, traffic, seed, device, CONTROL[traffic["compute_dtype"]], steps,
                            keep_first_grads=True)
    elif kind == "reference_nudged":
        run = ref_mod.train(cfg, traffic, seed, device, "f32", steps, keep_first_grads=True,
                            nudge=True)
    elif kind.startswith("reference_"):
        run = ref_mod.train(cfg, traffic, seed, device, kind[len("reference_"):], steps,
                            keep_first_grads=True)
    else:
        run = ref_mod.train(cfg, traffic, seed, device, "f32", steps, fault=kind,
                            keep_first_grads=True)
    free(device)
    # a planted fault's run is followed on the reference's own ellipse: its
    # stage 1 may have seen another batch
    teacher = None if kind in FAULTS else run.teacher
    ref = ref_mod.train(cfg, traffic, seed, device, "f32", steps, teacher=teacher,
                        against=run.first_grad_tensors)
    return {**train_numbers(run, ref), "detail": train_detail(run, ref)}


def infer_readings(cell, kind: str, seed: int, device, steps: Optional[int] = None,
                   batches: int = 4) -> dict:
    cfg, traffic = cell.config, cell.traffic
    system_mod, ref_mod = modules(cfg)
    pool = ref_mod.inference_pool(cfg, traffic, seed)[:batches]
    weights = ref_mod.weights(cfg, seed, device)
    f32 = Ops("f32")
    if kind == "program":
        server = system_mod.Server(cfg, traffic, seed, device, weights)
        outs = [{k: v.clone() for k, v in server(imgs).items()} for imgs in pool]
        server.close()
        del server
    else:
        ops = Ops(CONTROL[traffic["compute_dtype"]]) if kind == "control" else f32
        outs = []
        for imgs in pool:
            b = imgs.shape[0]
            if kind == "half_batch":
                imgs = imgs[:b // 2].repeat(2, 0)[:b]
            elif kind == "row_swapped":
                imgs = imgs.copy()
                imgs[-1] = imgs[0]
            outs.append(ref_mod.infer(cfg, weights, imgs, device, ops))
    teacher = system_mod.Server.teacher
    gaps = [output_gap(o, ref_mod.infer(cfg, weights, imgs, device, f32, teacher(o)))
            for o, imgs in zip(outs, pool)]
    free(device)
    return {"output_gap": max(gaps)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--witness-seeds", type=int, nargs="*", default=[],
                   help="the reference in --witness-precision put in the program's place "
                   "(training cells)")
    p.add_argument("--witness-precision", default="bf16", choices=("bf16", "f32_default"))
    p.add_argument("--nudged-seeds", type=int, nargs="*", default=[],
                   help="the f32 reference from its weights one ulp up (training cells)")
    p.add_argument("--steps", type=int, nargs="*", default=[None],
                   help="training steps a reading follows (the cell's compare_steps by default)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = find_cell(args.workload)
    device = torch.device("cuda", 0)
    train = cell.traffic["driver"] == "train_loop"
    readings = train_readings if train else infer_readings
    plan = ([("program", s) for s in args.program_seeds]
            + [("control", s) for s in args.control_seeds]
            + [(f, s) for f in FAULTS for s in args.fault_seeds]
            + [(f"reference_{args.witness_precision}", s) for s in args.witness_seeds]
            + [("reference_nudged", s) for s in args.nudged_seeds])
    out = open(args.out, "a") if args.out else None
    try:
        for steps in args.steps:
            for kind, seed in plan:
                t = time.perf_counter()
                line = {"cell": cell.name, "kind": kind, "seed": seed, "steps": steps,
                        **readings(cell, kind, seed, device, steps),
                        "seconds": round(time.perf_counter() - t, 3)}
                print(json.dumps(line), flush=True)
                if out:
                    out.write(json.dumps(line) + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
