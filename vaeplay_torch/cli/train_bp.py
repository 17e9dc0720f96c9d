"""BP trainer CLI -- port of vaeplay_tpu/cli/train_bp.py (rebuild of the
reference train_BP.py).

    python -m vaeplay_torch.cli.train_bp --gpu 0
    python -m vaeplay_torch.cli.train_bp --path DATA --epoch 4 --gpu 0
    python -m vaeplay_torch.cli.train_bp --dtype bfloat16 --gpu 0
    python -m vaeplay_torch.cli.train_bp --resume logs/BP/<timestamp> --epoch 8 --gpu 0

Defaults match the reference (train_BP.py:131-145): 512 px, batch 8, 1 epoch
x 500 iterations, Adam 1e-3 with StepLR(2, 0.1), which is applied per
optimizer step, two per iteration. `--dtype bfloat16` runs both passes under
bf16 autocast with f32 state (utils/amp.py). Runs on `cuda:<--gpu>`; `--device cpu`
runs on the CPU (it raises without a card otherwise). Weights start from the
port's seeded init (`--seed`). Without `--path` it trains on the synthetic
emit-line dataset. Each run writes record.txt, metrics.jsonl and one
checkpoint per epoch into <model_output>/BP/<timestamp>/; `--resume` loads
the latest checkpoint of an earlier run dir and goes on from the epoch after
it, in a run dir of its own.
"""

import argparse
import os
from datetime import datetime

import torch

from vaeplay_torch.data.bp_data import BPDataset, SyntheticEmitDataset
from vaeplay_torch.data.prefetch import epoch_iterator
from vaeplay_torch.device import resolve_device
from vaeplay_torch.models.bp import ComposeNet
from vaeplay_torch.train.checkpoint import (Checkpointer, make_run_dir, restore_state,
                                            save_state)
from vaeplay_torch.train.metrics import accumulating, fetch_averages
from vaeplay_torch.train.state import TrainState, step_lr_every_two_epochs
from vaeplay_torch.train.steps_bp import make_bp_train_step
from vaeplay_torch.utils.amp import resolve_dtype
from vaeplay_torch.utils.metrics_log import MetricsLogger

AVG_KEYS = ("loss_cx", "loss_cy", "loss_rest", "trig_loss", "param_loss")


def to_device(batch, device: torch.device):
    """A host batch of numpy arrays as f32 tensors on `device`."""
    return tuple(torch.from_numpy(a).float().to(device) for a in batch)


def main(argv=None) -> str:
    """Run the trainer; returns its run dir (the checkpoints' directory)."""
    parser = argparse.ArgumentParser(description="BP (ellipse + emit line) trainer, PyTorch/CUDA")
    parser.add_argument("--path", type=str, dest="path", default=None)
    parser.add_argument("--lr", type=float, dest="lr", default=1e-3)
    parser.add_argument("--gpu", type=int, dest="gpu", default=0)
    parser.add_argument("--device", type=str, dest="device", default=None,
                        choices=["cpu"], help="run on the CPU instead of --gpu")
    parser.add_argument("--epoch", type=int, dest="epochs", default=1)
    parser.add_argument("--iterations", type=int, dest="iterations", default=500)
    parser.add_argument("--batchsize", type=int, dest="batchsize", default=8)
    parser.add_argument("--workers", type=int, dest="workers", default=0)
    parser.add_argument("--img_size", type=int, dest="img_size", default=512)
    parser.add_argument("--res_output", type=str, dest="res_output", default="./results")
    parser.add_argument("--model_output", type=str, dest="model_output", default="./logs")
    parser.add_argument("--viz_freq", type=int, dest="viz_freq", default=50)
    parser.add_argument("--seed", type=int, dest="seed", default=0)
    parser.add_argument("--dtype", type=str, dest="dtype", default="float32",
                        choices=("float32", "f32", "bfloat16", "bf16"),
                        help="compute dtype of the forward and backward (bfloat16: bf16 "
                             "autocast); parameters, optimizer state and losses stay f32")
    parser.add_argument("--resume", type=str, dest="resume", default=None,
                        help="run dir of a previous checkpoint to resume from")
    args = parser.parse_args(argv)
    device = resolve_device(args.gpu, args.device)
    cdtype = resolve_dtype(args.dtype)

    stamp = datetime.now().strftime("%Y%m%d-%H%M%S")
    args.res_output = make_run_dir(args.res_output, "BP", stamp)
    args.model_output = make_run_dir(args.model_output, "BP", stamp)
    with open(os.path.join(args.model_output, "record.txt"), "w") as f:
        for arg in vars(args):
            f.write("{:35}{:20}\n".format(arg, str(getattr(args, arg))))

    model = ComposeNet(image_size=args.img_size,
                       generator=torch.Generator().manual_seed(args.seed)).to(device)
    state = TrainState.create(model, args.lr, step_lr_every_two_epochs(args.iterations))
    start_epoch = 0
    if args.resume:
        state, tag = restore_state(args.resume, state)
        start_epoch = tag + 1
        print(f"resumed epoch {tag} from {args.resume}")
    astep = accumulating(make_bp_train_step(model, cdtype))
    ckpt = Checkpointer(args.model_output)
    mlog = MetricsLogger(args.model_output)

    if args.path:
        dset = BPDataset(args.path, args.img_size)
    else:
        print("no --path given; using the synthetic emit-line dataset")
        dset = SyntheticEmitDataset(img_size=args.img_size,
                                    data_size=args.iterations * args.batchsize)

    model.train()
    for epoch in range(start_epoch, args.epochs):
        it = epoch_iterator(dset, args.batchsize, epoch, workers=args.workers)
        acc, cnt = None, 0
        for i in range(args.iterations):
            try:
                batch = next(it)
            except StopIteration:
                it = epoch_iterator(dset, args.batchsize, epoch * 7919 + i, workers=args.workers)
                batch = next(it)
            state, acc, cnt = astep(state, acc, cnt, *to_device(batch, device))
            if (i + 1) % args.viz_freq == 0:
                avg = fetch_averages(acc, cnt)
                print(f"[epoch {epoch}] " + " ".join(f"{k}={avg[k]:.6f}" for k in AVG_KEYS))
                mlog.log(epoch * args.iterations + i + 1, {k: avg[k] for k in AVG_KEYS},
                         epoch=epoch)
        save_state(ckpt, epoch, state)
        print(f"epoch {epoch} checkpoint -> {ckpt.path(epoch)}")
    return args.model_output


if __name__ == "__main__":
    main()
