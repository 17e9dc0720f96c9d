"""BE (bubble mask + edge) trainer CLI -- port of vaeplay_tpu/cli/train_be.py
(rebuild of the reference train_BE.py).

    python -m vaeplay_torch.cli.train_be --gpu 0
    python -m vaeplay_torch.cli.train_be --path DATA --dtype bfloat16 --gpu 0
    python -m vaeplay_torch.cli.train_be --resume logs/BE/<timestamp> --epoch 2 --gpu 0

Flags are the JAX CLI's (the reference's, train_BE.py:81-98): 512 px, batch
32, Adam 1e-4 over everything but the frozen backbone stem and layer1. Runs
on `cuda:<--gpu>`; `--device cpu` runs on the CPU (it raises without a card
otherwise). Weights start from the port's seeded init (`--seed`);
`--backbone_ckpt` loads a torchvision resnet50(-FPN) file into the backbone
first (there are no pretrained weights in the repo). Without `--path`, the
synthetic bubbles (the JAX CLI's batches for a seed) are rendered on the
device from their parameter tables; with it, the reference's folders are
read on the host. Every batch gets the joint rotation/flip on the device;
`--dtype bfloat16` runs forward and backward under bf16 autocast with f32
state (utils/amp.py). Each run writes record.txt, metrics.jsonl and one
checkpoint per epoch into <model_output>/BE/<timestamp>/, and at every
`--viz_freq` iterations an inputs | masks | edges grid into
<res_output>/BE/<timestamp>/<epoch>_<i>.png; `--resume` loads the latest
checkpoint of an earlier run dir and goes on from the epoch after it, in a
run dir of its own.
"""

import argparse
import os
from datetime import datetime
from typing import Iterator, Tuple

import numpy as np
import torch

from vaeplay_torch.data.be_data import BEDataset, SyntheticBubbleDataset, render_bubble_batch
from vaeplay_torch.data.prefetch import epoch_iterator
from vaeplay_torch.device import resolve_device
from vaeplay_torch.eval.be_eval import save_test_batch
from vaeplay_torch.models.backbone import transplant_backbone
from vaeplay_torch.models.be import ComposeNet
from vaeplay_torch.train.checkpoint import Checkpointer, make_run_dir, restore_state, save_state
from vaeplay_torch.train.metrics import accumulating, fetch_averages
from vaeplay_torch.train.state import TrainState, frozen_backbone_adam
from vaeplay_torch.train.steps_be import METRIC_KEYS, augment, make_be_eval_step, make_be_train_step
from vaeplay_torch.utils.amp import resolve_dtype
from vaeplay_torch.utils.metrics_log import MetricsLogger
from vaeplay_torch.utils.profiling import StepTimer

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def build_state(lr: float, seed: int, device: torch.device, backbone_ckpt: str = None) -> TrainState:
    """The seeded ComposeNet (the backbone file loaded into it, if given) on
    `device`, with frozen_backbone_adam(lr)."""
    model = ComposeNet(generator=torch.Generator().manual_seed(seed))
    if backbone_ckpt:
        n = transplant_backbone(backbone_ckpt, model)
        print(f"backbone checkpoint {backbone_ckpt}: loaded into {n} backbone(s)")
    return frozen_backbone_adam(model.to(device), lr)


def _nchw(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous().to(device)


def device_batches(dset, batch_size: int, seed: int, workers: int,
                   device: torch.device) -> Iterator[Batch]:
    """One epoch of (imgs, bimgs, eimgs) NCHW batches on `device`: the
    synthetic ones rendered there from their tables, the folder ones decoded
    on the host (`workers` threads, a prefetch thread) and copied."""
    if isinstance(dset, SyntheticBubbleDataset):
        for params, _ in dset.epoch_params(batch_size, seed):
            yield render_bubble_batch(dset.img_size, torch.from_numpy(params).to(device))
    else:
        for b in epoch_iterator(dset, batch_size, seed, workers):
            yield tuple(_nchw(b[k], device) for k in ("imgs", "bimgs", "eimgs"))


def main(argv=None) -> str:
    """Run the trainer; returns its run dir (the checkpoints' directory)."""
    parser = argparse.ArgumentParser(description="BE (bubble mask + edge) trainer, PyTorch/CUDA")
    parser.add_argument("--path", type=str, dest="path", default=None)
    parser.add_argument("--lr", type=float, dest="lr", default=1e-4)
    parser.add_argument("--gpu", type=int, dest="gpu", default=0)
    parser.add_argument("--device", type=str, dest="device", default=None,
                        choices=["cpu"], help="run on the CPU instead of --gpu")
    parser.add_argument("--epoch", type=int, dest="epochs", default=1)
    parser.add_argument("--iterations", type=int, dest="iterations", default=1000)
    parser.add_argument("--batchsize", type=int, dest="batchsize", default=32)
    parser.add_argument("--workers", type=int, dest="workers", default=0)
    parser.add_argument("--img_size", type=int, dest="img_size", default=512)
    parser.add_argument("--res_output", type=str, dest="res_output", default="./results")
    parser.add_argument("--model_output", type=str, dest="model_output", default="./logs")
    parser.add_argument("--viz_freq", type=int, dest="viz_freq", default=100)
    parser.add_argument("--seed", type=int, dest="seed", default=0)
    parser.add_argument("--backbone_ckpt", type=str, dest="backbone_ckpt", default=None,
                        help="torchvision resnet50 checkpoint (.pth/.pt/.npz) to load into "
                             "the FPN backbone: the reference's pretrained=True "
                             "(networks_BE.py:16)")
    parser.add_argument("--resume", type=str, dest="resume", default=None,
                        help="run dir of a previous checkpoint to resume from")
    parser.add_argument("--dtype", type=str, dest="dtype", default="float32",
                        choices=("float32", "f32", "bfloat16", "bf16"),
                        help="compute dtype of the forward and backward; parameters, "
                             "optimizer state, BN statistics and losses stay f32")
    args = parser.parse_args(argv)
    device = resolve_device(args.gpu, args.device)
    cdtype = resolve_dtype(args.dtype)

    stamp = datetime.now().strftime("%Y%m%d-%H%M%S")
    args.res_output = make_run_dir(args.res_output, "BE", stamp)
    args.model_output = make_run_dir(args.model_output, "BE", stamp)
    with open(os.path.join(args.model_output, "record.txt"), "w") as f:
        for arg in vars(args):
            f.write("{:35}{:20}\n".format(arg, str(getattr(args, arg))))

    if args.path:
        dset = BEDataset(args.path, (args.img_size, args.img_size))
    else:
        print("no --path given; using the synthetic bubble dataset, rendered on the device")
        dset = SyntheticBubbleDataset(img_size=args.img_size,
                                      data_size=args.iterations * args.batchsize)

    state = build_state(args.lr, args.seed, device, args.backbone_ckpt)
    model = state.model
    start_epoch = 0
    if args.resume:
        state, tag = restore_state(args.resume, state)
        start_epoch = tag + 1
        print(f"resumed epoch {tag} from {args.resume}")
    astep = accumulating(make_be_train_step(model, cdtype))
    eval_step = make_be_eval_step(model)
    ckpt = Checkpointer(args.model_output)
    mlog = MetricsLogger(args.model_output)
    generator = torch.Generator(device=device).manual_seed(args.seed + 1)

    model.train()
    for epoch in range(start_epoch, args.epochs):
        it = device_batches(dset, args.batchsize, epoch, args.workers, device)
        acc, cnt, timer = None, 0, StepTimer()
        for i in range(args.iterations):
            try:
                batch = next(it)
            except StopIteration:
                it = device_batches(dset, args.batchsize, epoch * 7919 + i, args.workers, device)
                batch = next(it)
            imgs, bimgs, eimgs = augment(*batch, generator)
            state, acc, cnt = astep(state, acc, cnt, imgs, bimgs, eimgs)
            if (i + 1) % args.viz_freq == 0:
                avg = fetch_averages(acc, cnt)  # waits for the device
                timer.lap(args.viz_freq * args.batchsize)
                print(f"[epoch {epoch}] it {i + 1}: "
                      + " ".join(f"{k}={avg[k]:.6f}" for k in METRIC_KEYS)
                      + f" | {timer.items_per_sec:.1f} img/s")
                mlog.log(epoch * args.iterations + i + 1, {k: avg[k] for k in METRIC_KEYS},
                         epoch=epoch, images_per_sec=timer.items_per_sec)
                save_test_batch(imgs, eval_step(imgs), args.res_output, f"{epoch}_{i + 1}")
        save_state(ckpt, epoch, state)
        print(f"epoch {epoch} checkpoint -> {ckpt.path(epoch)}")
    return args.model_output


if __name__ == "__main__":
    main()
