"""BC (contour refine) trainer CLI -- port of vaeplay_tpu/cli/train_bc.py
(rebuild of the reference train_BC.py).

    python -m vaeplay_torch.cli.train_bc --gpu 0
    python -m vaeplay_torch.cli.train_bc --path DATA --dtype bfloat16 --gpu 0
    python -m vaeplay_torch.cli.train_bc --resume logs/BC/<timestamp> --epoch 30 --gpu 0

Flags are the JAX CLI's (the reference's defaults, train_BC.py:90-103):
256 px, batch 32, 20 epochs, up to 256 contour points, Adam 1e-4 over
everything but the frozen backbone stem and layer1, StepLR(10, 0.5) counted
in epochs. Runs on `cuda:<--gpu>`; `--device cpu` runs on the CPU (it raises
without a card otherwise). Weights start from the port's seeded init
(`--seed`); `--backbone_ckpt` loads a torchvision resnet50(-FPN) file into the
backbone first. Without `--path`, synthetic bubbles with their traced
targets (`--iterations` batches an epoch); with it, a BCDataset tree.
Each run writes record.txt and metrics.jsonl into
<model_output>/BC/<timestamp>/, and a checkpoint per epoch from epoch 10 on,
or every epoch when `--epoch` is at most 10 (train_BC.py:134); `--resume`
loads the latest checkpoint of an earlier run dir and goes on from the
epoch after it, in a run dir of its own.

The contours of each forward's masks are traced on the host inside the
forward. On a mesh of more than one rank (`--mesh DxM`, D x M ranks
launched by `torchrun --standalone --nproc_per_node N -m
vaeplay_torch.cli.train_bc --mesh DxM`), the trainer takes the JAX
package's two-program bridge instead, as the JAX trainer does on a
multi-device mesh: the mask program, then the trace of its packed mask
(`--bridge_stride` subsamples it) on a worker thread, then the train step on
the traced contours. `--bridge sync` waits for each batch's trace;
`--bridge overlap` traces batch i+1's masks (from the weights before step i,
one step stale) while step i runs, and flushes at each epoch's end. Each
rank takes its rows of the `--batchsize` global batch; the heads'
BatchNorms see the global batch's statistics; M > 1 shards the weights and
Adam state over "model" (FSDP2). Rank 0 prints and writes, and checkpoints
are whole. `--mesh 1x1` runs on one card, in-forward.
"""

import argparse
import os
import time
from datetime import datetime
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vaeplay_torch.data.bc_data import BCDataset, SyntheticBCDataset
from vaeplay_torch.data.prefetch import epoch_iterator
from vaeplay_torch.device import resolve_device
from vaeplay_torch.models.backbone import transplant_backbone
from vaeplay_torch.models.bc import ComposeNet, trace_contours
from vaeplay_torch.parallel.mesh import (axis_size, broadcast_object, global_batchnorm, is_main,
                                         main_print, mesh_session, shard_batch, shard_state)
from vaeplay_torch.train.checkpoint import Checkpointer, make_run_dir, restore_state, save_state
from vaeplay_torch.train.metrics import accumulating, fetch_averages
from vaeplay_torch.train.state import TrainState, frozen_backbone_adam, step_lr_by_epoch
from vaeplay_torch.train.steps_bc import (METRIC_KEYS, TARGET_KEYS, BridgeTracer,
                                          make_bc_mask_step, make_bc_train_step)
from vaeplay_torch.utils.amp import resolve_dtype
from vaeplay_torch.utils.metrics_log import MetricsLogger
from vaeplay_torch.utils.profiling import StepTimer


def build_state(lr: float, seed: int, max_points: int, refine_dtype: torch.dtype,
                iters_per_epoch: int, device: torch.device,
                backbone_ckpt: str = None) -> TrainState:
    """The seeded ComposeNet (the backbone file loaded into it, if given) on
    `device`, with frozen_backbone_adam(lr) and StepLR(10, 0.5) a epoch."""
    model = ComposeNet(max_points, refine_fc_dtype=refine_dtype,
                       generator=torch.Generator().manual_seed(seed))
    if backbone_ckpt:
        n = transplant_backbone(backbone_ckpt, model)
        print(f"backbone checkpoint {backbone_ckpt}: loaded into {n} backbone(s)")
    return frozen_backbone_adam(model.to(device), lr, schedule=step_lr_by_epoch(iters_per_epoch))


def device_batch(b: dict, device: torch.device) -> tuple:
    """A host batch as the step's (imgs, bimgs, eimgs, tgt_pts, tgt_mask,
    key_pts, key_mask) on `device`, the images NCHW."""
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2).contiguous().to(device)
    return (nchw(b["imgs"]), nchw(b["bimgs"]), nchw(b["eimgs"]),
            *(torch.from_numpy(np.ascontiguousarray(b[k])).to(device) for k in TARGET_KEYS[2:]))


def main(argv=None) -> str:
    """Run the trainer; returns its run dir (the checkpoints' directory)."""
    parser = argparse.ArgumentParser(description="BC (contour refine) trainer, PyTorch/CUDA")
    parser.add_argument("--path", type=str, dest="path", default=None)
    parser.add_argument("--lr", type=float, dest="lr", default=1e-4)
    parser.add_argument("--gpu", type=int, dest="gpu", default=0)
    parser.add_argument("--device", type=str, dest="device", default=None,
                        choices=["cpu"], help="run on the CPU instead of --gpu")
    parser.add_argument("--epoch", type=int, dest="epochs", default=20)
    parser.add_argument("--batchsize", type=int, dest="batchsize", default=32)
    parser.add_argument("--workers", type=int, dest="workers", default=0)
    parser.add_argument("--img_size", type=int, dest="img_size", default=256)
    parser.add_argument("--max_points", type=int, dest="max_points", default=256)
    parser.add_argument("--res_output", type=str, dest="res_output", default="./results")
    parser.add_argument("--model_output", type=str, dest="model_output", default="./logs")
    parser.add_argument("--viz_freq", type=int, dest="viz_freq", default=10)
    parser.add_argument("--iterations", type=int, dest="iterations", default=64,
                        help="iterations per epoch for the synthetic dataset")
    parser.add_argument("--refine_dtype", type=str, dest="refine_dtype", default="float32",
                        choices=("float32", "bfloat16"),
                        help="dtype of RefineNet's two linear layers and their Adam state. "
                             "float32, the reference's precision, is the default: at 256 "
                             "points fc0 has 545 M weights, and its weight, gradient and two "
                             "Adam moments take about 8.7 GB in f32, which the 80 GB card "
                             "holds. bfloat16 halves that (the JAX package's default, set "
                             "for a 16 GB TPU chip)")
    parser.add_argument("--bridge_stride", type=int, dest="bridge_stride", default=4,
                        help="subsample factor of the two-program bridge's mask (1 = full "
                             "resolution); the bridge runs on a mesh of more than one rank")
    parser.add_argument("--bridge", type=str, dest="bridge", default="overlap",
                        choices=("overlap", "sync"),
                        help="overlap: trace batch i+1's contours (one-step-stale masks) "
                             "while step i runs; sync: one blocking trace a step, the "
                             "reference's semantics")
    parser.add_argument("--dtype", type=str, dest="dtype", default="float32",
                        choices=("float32", "f32", "bfloat16", "bf16"),
                        help="compute dtype of the convolution stages (independent of "
                             "--refine_dtype; the refine stage's attention stays f32); "
                             "parameters, optimizer state, BN statistics and losses stay f32")
    parser.add_argument("--mesh", type=str, dest="mesh", default=None,
                        help="device mesh DATAxMODEL, e.g. 4x2, one rank a card (launch "
                             "D x M ranks with torchrun; 1x1 needs none): the batch is split "
                             "over data, the weights and Adam state shard over model")
    parser.add_argument("--seed", type=int, dest="seed", default=0)
    parser.add_argument("--backbone_ckpt", type=str, dest="backbone_ckpt", default=None,
                        help="torchvision resnet50 checkpoint (.pth/.pt/.npz) to load into "
                             "the FPN backbone: the reference's pretrained=True")
    parser.add_argument("--resume", type=str, dest="resume", default=None,
                        help="run dir of a previous checkpoint to resume from")
    args = parser.parse_args(argv)
    with mesh_session(args.mesh, resolve_device(args.gpu, args.device)) as (mesh, device):
        return train(args, device, mesh)


def run_epoch(astep: Callable, state: TrainState, batches: Iterable[tuple],
              bridge: Optional[Tuple[Callable, BridgeTracer]] = None, overlap: bool = False,
              on_iteration: Optional[Callable] = None) -> Tuple[TrainState, dict, int]:
    """One epoch of `astep` (accumulating(make_bc_train_step)) over device
    batches (imgs, bimgs, eimgs, tgt_pts, tgt_mask, key_pts, key_mask);
    returns (state, metric sums, count). bridge None traces in the forward;
    (mask_step, tracer) takes the bridge (JAX cli/train_bc.py:164-205): each
    batch's mask program is dispatched first and traced on the tracer's
    thread, then the train step runs on its contours, at once (sync) or
    after the previous batch's step (overlap), the last batch flushed at the
    end. on_iteration(i, acc, count) runs after batch i's dispatch."""
    acc, cnt = None, 0
    pending = None  # overlap: (tensors, trace future) awaiting its train step

    def trace_and_train(state, acc, cnt, tensors, fut):
        pts, counts = fut.result()
        dev = tensors[0].device
        contours = (torch.from_numpy(pts).to(dev), torch.from_numpy(counts).to(dev))
        return astep(state, acc, cnt, *tensors, contours)

    for i, tensors in enumerate(batches):
        if bridge is None:
            state, acc, cnt = astep(state, acc, cnt, *tensors)
        else:
            mask_step, tracer = bridge
            fut = tracer.submit(mask_step(state, tensors[0]))
            if overlap:
                if pending is not None:
                    state, acc, cnt = trace_and_train(state, acc, cnt, *pending)
                pending = (tensors, fut)
            else:
                state, acc, cnt = trace_and_train(state, acc, cnt, tensors, fut)
        if on_iteration is not None:
            on_iteration(i, acc, cnt)
    if pending is not None:
        state, acc, cnt = trace_and_train(state, acc, cnt, *pending)
    return state, acc, cnt


def train(args, device: torch.device, mesh=None) -> str:
    """main's run on `device`, on this rank of `mesh` (None: no mesh)."""
    cdtype, rdtype = resolve_dtype(args.dtype), resolve_dtype(args.refine_dtype)
    main_rank = is_main(mesh)
    say = main_print(mesh)

    stamp = broadcast_object(datetime.now().strftime("%Y%m%d-%H%M%S"), mesh)
    args.res_output = make_run_dir(args.res_output, "BC", stamp)
    args.model_output = make_run_dir(args.model_output, "BC", stamp)
    if main_rank:
        with open(os.path.join(args.model_output, "record.txt"), "w") as f:
            for arg in vars(args):
                f.write("{:35}{:20}\n".format(arg, str(getattr(args, arg))))

    if args.path:
        dset = BCDataset(args.path, (args.img_size, args.img_size), max_points=args.max_points)
        iters_per_epoch = max(len(dset) // args.batchsize, 1)
    else:
        say("no --path given; using the synthetic BC dataset")
        dset = SyntheticBCDataset(img_size=args.img_size, max_points=args.max_points,
                                  data_size=args.iterations * args.batchsize)
        iters_per_epoch = args.iterations

    state = build_state(args.lr, args.seed, args.max_points, rdtype, iters_per_epoch, device,
                        args.backbone_ckpt)
    start_epoch = 0
    if args.resume:
        state, tag = restore_state(args.resume, state)
        start_epoch = tag + 1
        say(f"resumed epoch {tag} from {args.resume}")
    if global_batchnorm(state.model, mesh):
        say("BatchNorm statistics over the global batch (all-reduced over data)")
    if shard_state(mesh, state):
        say(f"weights and Adam state sharded over {axis_size(mesh, 'model')} model ranks (FSDP2)")
    astep = accumulating(make_bc_train_step(state.model, cdtype, mesh))
    bridge = None
    if mesh is not None and dist.get_world_size() > 1:
        stride = max(args.bridge_stride, 1)
        bridge = (make_bc_mask_step(state.model, stride, cdtype),
                  BridgeTracer(args.img_size, stride, args.max_points))
        say(f"using the two-program contour bridge ({args.bridge}, stride {stride}) for the "
            f"{dist.get_world_size()}-rank mesh")
    else:
        say("tracing the contours inside the forward")

    def trace_seconds() -> float:  # the host trace's seconds so far, on either path
        return bridge[1].trace_seconds if bridge else trace_contours.trace_seconds
    ckpt = Checkpointer(args.model_output)
    mlog = MetricsLogger(args.model_output)

    state.model.train()
    for epoch in range(start_epoch, args.epochs):
        timer, traced = StepTimer(), [trace_seconds()]

        def log(i, acc, cnt):
            if (i + 1) % args.viz_freq or not cnt:
                return
            avg = fetch_averages(acc, cnt, mesh)  # waits for the device
            timer.lap(args.viz_freq * args.batchsize)
            trace_ms = (trace_seconds() - traced[0]) * 1e3 / args.viz_freq
            traced[0] = trace_seconds()
            say(f"epoch[{epoch}] " + " ".join(f"{k}={avg[k]:.6f}" for k in METRIC_KEYS)
                + f" | {timer.items_per_sec:.1f} img/s, host trace {trace_ms:.2f} ms/it")
            if main_rank:
                mlog.log(epoch * args.iterations + i + 1, {k: avg[k] for k in METRIC_KEYS},
                         epoch=epoch, images_per_sec=timer.items_per_sec,
                         trace_ms_per_iteration=trace_ms)

        batches = (device_batch(shard_batch(mesh, b), device)
                   for b in epoch_iterator(dset, args.batchsize, epoch, args.workers))
        state, _, _ = run_epoch(astep, state, batches, bridge, args.bridge == "overlap", log)
        if epoch >= 10 or args.epochs <= 10:  # the reference saves from epoch 10 on
            t = time.perf_counter()
            path = save_state(ckpt, epoch, state, mesh)
            say(f"epoch {epoch} checkpoint -> {path} ({os.path.getsize(path) / 2**30:.2f} GiB "
                f"in {time.perf_counter() - t:.1f} s)")
    if bridge is not None:
        bridge[1].close()
    return args.model_output

if __name__ == "__main__":
    main()
