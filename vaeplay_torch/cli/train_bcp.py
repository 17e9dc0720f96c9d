"""BCP trainer CLI -- port of vaeplay_tpu/cli/train_bcp.py (rebuild of the
reference train_BCP.py).

    python -m vaeplay_torch.cli.train_bcp --gpu 0
    python -m vaeplay_torch.cli.train_bcp --path DATA --dtype bfloat16 --gpu 0
    python -m vaeplay_torch.cli.train_bcp --point_attention --gpu 0
    python -m vaeplay_torch.cli.train_bcp --resume logs/BCP/<timestamp> --epoch 2 --gpu 0

Flags are the JAX CLI's (the reference's defaults, train_BCP.py:180-197):
512 px, batch 16, up to 2048 contour points, one epoch of 200 iterations,
Adam (betas (0.9, 0.999)) at `--lr` for G and `--lr_disc` for D, both
1e-3. Runs on `cuda:<--gpu>`; `--device cpu` runs on the CPU (it raises
without a card otherwise). Weights start from the port's seeded init (G
from `--seed`, D from `--seed` + 1). Without `--path`, synthetic emit
bubbles with per-point annotations; with it, a BCPDataset tree, decoded and
augmented on the host (`--workers` threads). `--point_attention` adds the
three point-attention blocks; `--dtype bfloat16` runs both nets under bf16
autocast with f32 state (utils/amp.py). Each run writes record.txt,
metrics.jsonl and one checkpoint per epoch (the whole GanState) into
<model_output>/BCP/<timestamp>/; `--resume` loads the latest checkpoint of
an earlier run dir, strictly, and goes on from the epoch after it.

`--mesh DxM` trains on D x M ranks, one a card, launched by `torchrun
--standalone --nproc_per_node N -m vaeplay_torch.cli.train_bcp --mesh DxM`
(`--mesh 1x1` runs on one card with no launcher). Each rank takes its rows
of the `--batchsize` global batch, the masked means are the global batch's,
and both nets stay replicated. With `--point_attention` and M > 1 the point
attention runs as ring attention over the "model" ranks
(ops.attention.RingRouting, min_n = min(1024, max_points)) when max_points
divides by M; otherwise it says so and runs unsharded, as the JAX trainer
does. Rank 0 prints and writes.
"""

import argparse
import os
import time
from datetime import datetime
from typing import Callable, Optional

import torch

from vaeplay_torch.data.bcp_data import BCPDataset, SyntheticBCPDataset
from vaeplay_torch.data.prefetch import epoch_iterator
from vaeplay_torch.device import resolve_device
from vaeplay_torch.models.bcp import ComposeNet, Discriminator
from vaeplay_torch.ops.attention import RingRouting
from vaeplay_torch.parallel.mesh import (axis_size, broadcast_object, is_main, main_print,
                                         mesh_session, shard_batch)
from vaeplay_torch.train.checkpoint import Checkpointer, make_run_dir, restore_state, save_state
from vaeplay_torch.train.metrics import accumulating, fetch_averages
from vaeplay_torch.train.state import GanState, TrainState
from vaeplay_torch.train.steps_bcp import METRIC_KEYS, make_bcp_train_step
from vaeplay_torch.utils.amp import resolve_dtype
from vaeplay_torch.utils.metrics_log import MetricsLogger
from vaeplay_torch.utils.profiling import StepTimer


def build_state(img_size: int, max_points: int, lr: float, lr_disc: float, seed: int,
                device: torch.device, point_attention: bool = False,
                ring: Optional[RingRouting] = None) -> GanState:
    """The seeded G (`seed`, its point attention through `ring`) and D
    (`seed` + 1) on `device`, each with Adam."""
    g = ComposeNet(max_points, point_attention, generator=torch.Generator().manual_seed(seed),
                   ring=ring)
    d = Discriminator(img_size, max_points, generator=torch.Generator().manual_seed(seed + 1))
    return GanState(TrainState.create(g.to(device), lr), TrainState.create(d.to(device), lr_disc))


def device_batch(b: dict, device: torch.device) -> tuple:
    """A host batch as the step's (imgs NCHW, labels, points, pmask) on
    `device`."""
    imgs = torch.from_numpy(b["imgs"]).permute(0, 3, 1, 2).contiguous()
    return tuple(t.to(device) for t in (imgs, torch.from_numpy(b["labels"]),
                                        torch.from_numpy(b["points"]),
                                        torch.from_numpy(b["pmask"])))


def main(argv=None) -> str:
    """Run the trainer; returns its run dir (the checkpoints' directory)."""
    parser = argparse.ArgumentParser(description="BCP (contour point GAN) trainer, PyTorch/CUDA")
    parser.add_argument("--path", type=str, dest="path", default=None)
    parser.add_argument("--lr", type=float, dest="lr", default=1e-3)
    parser.add_argument("--lr_disc", type=float, dest="lr_disc", default=1e-3)
    parser.add_argument("--gpu", type=int, dest="gpu", default=0)
    parser.add_argument("--device", type=str, dest="device", default=None,
                        choices=["cpu"], help="run on the CPU instead of --gpu")
    parser.add_argument("--epoch", type=int, dest="epochs", default=1)
    parser.add_argument("--iterations", type=int, dest="iterations", default=200)
    parser.add_argument("--batchsize", type=int, dest="batchsize", default=16)
    parser.add_argument("--workers", type=int, dest="workers", default=0)
    parser.add_argument("--img_size", type=int, dest="img_size", default=512)
    parser.add_argument("--max_points", type=int, dest="max_points", default=2048)
    parser.add_argument("--res_output", type=str, dest="res_output", default="./results")
    parser.add_argument("--model_output", type=str, dest="model_output", default="./logs")
    parser.add_argument("--viz_freq", type=int, dest="viz_freq", default=10)
    parser.add_argument("--seed", type=int, dest="seed", default=0)
    parser.add_argument("--dtype", type=str, dest="dtype", default="float32",
                        choices=("float32", "f32", "bfloat16", "bf16"),
                        help="compute dtype of both nets' forward and backward; parameters, "
                             "optimizer state and losses stay f32")
    parser.add_argument("--resume", type=str, dest="resume", default=None,
                        help="run dir of a previous checkpoint to resume from")
    parser.add_argument("--mesh", type=str, dest="mesh", default=None,
                        help="device mesh DATAxMODEL, e.g. 1x4, one rank a card (launch "
                             "D x M ranks with torchrun; 1x1 needs none): the batch is split "
                             "over data; --point_attention rings over model")
    parser.add_argument("--point_attention", action="store_true", dest="point_attention",
                        help="the 3-block point self-attention stack (the reference's "
                             "commented-out batch_attention, networks_BCP.py:122-126)")
    args = parser.parse_args(argv)
    with mesh_session(args.mesh, resolve_device(args.gpu, args.device)) as (mesh, device):
        return train(args, device, mesh)


def ring_routing(mesh, max_points: int, point_attention: bool,
                 say: Callable = print) -> Optional[RingRouting]:
    """The JAX trainer's rule (cli/train_bcp.py:76-89): a RingRouting with
    min_n = min(1024, max_points) for --point_attention on M > 1 model
    ranks, when it is active at max_points; None otherwise."""
    n_model = axis_size(mesh, "model")
    if not point_attention or n_model == 1:
        return None
    ring = RingRouting(mesh, min_n=min(1024, max_points))
    if ring.active(max_points):
        say(f"ring attention: point axis ({max_points}) sharded over {n_model} model ranks")
        return ring
    say(f"ring attention NOT active: max_points ({max_points}) must be divisible by the model "
        f"axis ({n_model}) -- attention runs unsharded")
    return None


def train(args, device: torch.device, mesh=None) -> str:
    """main's run on `device`, on this rank of `mesh` (None: no mesh)."""
    cdtype = resolve_dtype(args.dtype)
    main_rank = is_main(mesh)
    say = main_print(mesh)

    stamp = broadcast_object(datetime.now().strftime("%Y%m%d-%H%M%S"), mesh)
    args.res_output = make_run_dir(args.res_output, "BCP", stamp)
    args.model_output = make_run_dir(args.model_output, "BCP", stamp)
    if main_rank:
        with open(os.path.join(args.model_output, "record.txt"), "w") as f:
            for arg in vars(args):
                f.write("{:35}{:20}\n".format(arg, str(getattr(args, arg))))

    ring = ring_routing(mesh, args.max_points, args.point_attention, say)
    gs = build_state(args.img_size, args.max_points, args.lr, args.lr_disc, args.seed, device,
                     args.point_attention, ring)
    start_epoch = 0
    if args.resume:
        gs, tag = restore_state(args.resume, gs)
        start_epoch = tag + 1
        say(f"resumed epoch {tag} from {args.resume}")
    astep = accumulating(make_bcp_train_step(gs.g.model, gs.d.model, cdtype, mesh))
    ckpt = Checkpointer(args.model_output)
    mlog = MetricsLogger(args.model_output)

    if args.path:
        dset = BCPDataset(args.path, args.img_size, args.max_points)
    else:
        say("no --path given; using the synthetic BCP dataset")
        dset = SyntheticBCPDataset(img_size=args.img_size, max_points=args.max_points,
                                   data_size=args.iterations * args.batchsize)

    gs.g.model.train()
    gs.d.model.train()
    for epoch in range(start_epoch, args.epochs):
        it = epoch_iterator(dset, args.batchsize, epoch, args.workers)
        acc, cnt, timer = None, 0, StepTimer()
        for i in range(args.iterations):
            try:
                b = next(it)
            except StopIteration:  # a dataset smaller than an epoch starts over
                it = epoch_iterator(dset, args.batchsize, epoch * 7919 + i, args.workers)
                b = next(it)
            gs, acc, cnt = astep(gs, acc, cnt, *device_batch(shard_batch(mesh, b), device))
            if (i + 1) % args.viz_freq == 0:
                avg = fetch_averages(acc, cnt, mesh)  # waits for the device
                timer.lap(args.viz_freq * args.batchsize)
                say(f"[epoch {epoch}] " + " ".join(f"{k}={avg[k]:.6f}" for k in METRIC_KEYS)
                    + f" | {timer.items_per_sec:.1f} img/s")
                if main_rank:
                    mlog.log(epoch * args.iterations + i + 1, {k: avg[k] for k in METRIC_KEYS},
                             epoch=epoch, images_per_sec=timer.items_per_sec)
        t = time.perf_counter()
        path = save_state(ckpt, epoch, gs, mesh)
        say(f"epoch {epoch} checkpoint -> {path} ({os.path.getsize(path) / 2**30:.2f} GiB "
            f"in {time.perf_counter() - t:.1f} s)")
    return args.model_output


if __name__ == "__main__":
    main()
