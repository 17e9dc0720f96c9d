"""BE_GAN trainer CLI -- port of vaeplay_tpu/cli/train_be_gan.py (rebuild of
the reference train_BE_GAN.py).

    python -m vaeplay_torch.cli.train_be_gan --gpu 0
    python -m vaeplay_torch.cli.train_be_gan --path DATA --aug_path MANGA --gpu 0
    python -m vaeplay_torch.cli.train_be_gan --resume logs/BE_GAN/<timestamp> --epochs 12

Flags are the JAX CLI's (the reference's, train_BE_GAN.py:189-207): 512 px,
batch 16, 10 epochs of 200 iterations; Adam with betas (0.5, 0.999) for G at
`--lr` (everything but the frozen backbone stem and layer1) and for D at
`--lr` x 0.1 (train_BE_GAN.py:236-237). Runs on `cuda:<--gpu>`; `--device
cpu` runs on the CPU (it raises without a card otherwise). Weights start
from the port's seeded init (G from `--seed`, D from `--seed` + 1);
`--backbone_ckpt` loads a torchvision resnet50(-FPN) file into G's backbone
first. Without `--path`, the synthetic bubbles and their labels (the JAX
CLI's batches for a seed) are rendered on the device from their parameter
tables; with it, the reference's folders are read and augmented on the host
(data/be_gan_data.py:BEGanDataset), and `--aug_path` composites the crops
onto manga pages, a new page every 10 iterations. The trainer augments
nothing on the device (the JAX BE_GAN trainer does not). `--dtype bfloat16`
runs both nets under bf16 autocast with f32 state (utils/amp.py). Each run
writes record.txt, metrics.jsonl and one checkpoint per epoch (the whole
GanState) into <model_output>/BE_GAN/<timestamp>/, and at every
`--viz_freq` iterations an inputs | masks | edges grid of G into
<res_output>/BE_GAN/<timestamp>/<epoch>_<i>_wgtm.png; `--resume` loads the
latest checkpoint of an earlier run dir and goes on from the epoch after it.
"""

import argparse
import os
from datetime import datetime
from typing import Iterator, Tuple

import numpy as np
import torch

from vaeplay_torch.data.be_data import SyntheticBubbleDataset, render_bubble_batch
from vaeplay_torch.data.be_gan_data import BEGanDataset, MangaPageDataset
from vaeplay_torch.data.prefetch import epoch_iterator
from vaeplay_torch.device import resolve_device
from vaeplay_torch.eval.be_eval import save_test_batch
from vaeplay_torch.models.backbone import transplant_backbone
from vaeplay_torch.models.be_gan import ComposeNet, Discriminator
from vaeplay_torch.train.checkpoint import Checkpointer, make_run_dir, restore_state, save_state
from vaeplay_torch.train.metrics import accumulating, fetch_averages
from vaeplay_torch.train.state import GanState, TrainState, frozen_backbone_adam
from vaeplay_torch.train.steps_be import make_be_eval_step
from vaeplay_torch.train.steps_be_gan import METRIC_KEYS, make_be_gan_train_step
from vaeplay_torch.utils.amp import resolve_dtype
from vaeplay_torch.utils.metrics_log import MetricsLogger
from vaeplay_torch.utils.profiling import StepTimer

BETAS = (0.5, 0.999)  # both Adams (train_BE_GAN.py:236-237)
NUM_CLASSES = 4
Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def build_state(img_size: int, lr: float, seed: int, device: torch.device,
                backbone_ckpt: str = None) -> GanState:
    """The seeded G (the backbone file loaded into it, if given) with
    frozen_backbone_adam(lr), and the seeded D with Adam(lr x 0.1), on
    `device`."""
    g = ComposeNet(generator=torch.Generator().manual_seed(seed))
    if backbone_ckpt:
        n = transplant_backbone(backbone_ckpt, g)
        print(f"backbone checkpoint {backbone_ckpt}: loaded into {n} backbone(s)")
    d = Discriminator(in_size=img_size, num_classes=NUM_CLASSES,
                      generator=torch.Generator().manual_seed(seed + 1))
    return GanState(g=frozen_backbone_adam(g.to(device), lr, BETAS),
                    d=TrainState.create(d.to(device), lr * 0.1, betas=BETAS))


def device_batches(dset, batch_size: int, seed: int, workers: int,
                   device: torch.device) -> Iterator[Batch]:
    """One epoch of (imgs, bimgs, eimgs, labels) NCHW batches on `device`:
    the synthetic ones rendered there from their tables, the folder ones
    loaded and augmented on the host (`workers` threads, a prefetch thread)
    and copied."""
    if isinstance(dset, SyntheticBubbleDataset):
        for params, labels in dset.epoch_params(batch_size, seed):
            yield (*render_bubble_batch(dset.img_size, torch.from_numpy(params).to(device)),
                   torch.from_numpy(labels).to(device))
    else:
        for b in epoch_iterator(dset, batch_size, seed, workers):
            yield (*(torch.from_numpy(b[k]).permute(0, 3, 1, 2).contiguous().to(device)
                     for k in ("imgs", "bimgs", "eimgs")),
                   torch.from_numpy(b["labels"]).to(device))


def main(argv=None) -> str:
    """Run the trainer; returns its run dir (the checkpoints' directory)."""
    parser = argparse.ArgumentParser(description="BE_GAN trainer, PyTorch/CUDA")
    parser.add_argument("--path", type=str, dest="path", default=None)
    parser.add_argument("--aug_path", type=str, dest="aug_path", default=None,
                        help="manga root whose pages the crops are composited onto")
    parser.add_argument("--lr", type=float, dest="lr", default=1e-4)
    parser.add_argument("--gpu", type=int, dest="gpu", default=0)
    parser.add_argument("--device", type=str, dest="device", default=None,
                        choices=["cpu"], help="run on the CPU instead of --gpu")
    parser.add_argument("--epochs", type=int, dest="epochs", default=10)
    parser.add_argument("--iterations", type=int, dest="iterations", default=200)
    parser.add_argument("--batchsize", type=int, dest="batchsize", default=16)
    parser.add_argument("--workers", type=int, dest="workers", default=0)
    parser.add_argument("--img_size", type=int, dest="img_size", default=512)
    parser.add_argument("--res_output", type=str, dest="res_output", default="./results")
    parser.add_argument("--model_output", type=str, dest="model_output", default="./logs")
    parser.add_argument("--viz_freq", type=int, dest="viz_freq", default=20)
    parser.add_argument("--seed", type=int, dest="seed", default=0)
    parser.add_argument("--backbone_ckpt", type=str, dest="backbone_ckpt", default=None,
                        help="torchvision resnet50 checkpoint (.pth/.pt/.npz) to load into "
                             "G's FPN backbone: the reference's pretrained=True")
    parser.add_argument("--dtype", type=str, dest="dtype", default="float32",
                        choices=("float32", "f32", "bfloat16", "bf16"),
                        help="compute dtype of the forward and backward; parameters, "
                             "optimizer state, BN statistics and losses stay f32")
    parser.add_argument("--resume", type=str, dest="resume", default=None,
                        help="run dir of a previous checkpoint to resume from")
    args = parser.parse_args(argv)
    device = resolve_device(args.gpu, args.device)
    cdtype = resolve_dtype(args.dtype)

    stamp = datetime.now().strftime("%Y%m%d-%H%M%S")
    args.res_output = make_run_dir(args.res_output, "BE_GAN", stamp)
    args.model_output = make_run_dir(args.model_output, "BE_GAN", stamp)
    with open(os.path.join(args.model_output, "record.txt"), "w") as f:
        for arg in vars(args):
            f.write("{:35}{:20}\n".format(arg, str(getattr(args, arg))))

    gs = build_state(args.img_size, args.lr, args.seed, device, args.backbone_ckpt)
    start_epoch = 0
    if args.resume:
        gs, tag = restore_state(args.resume, gs)
        start_epoch = tag + 1
        print(f"resumed epoch {tag} from {args.resume}")
    astep = accumulating(make_be_gan_train_step(gs.g.model, gs.d.model, cdtype))
    eval_step = make_be_eval_step(gs.g.model)
    ckpt = Checkpointer(args.model_output)
    mlog = MetricsLogger(args.model_output)

    if args.path:
        dset = BEGanDataset(args.path, args.img_size)
    else:
        print("no --path given; using the synthetic bubble dataset, rendered on the device")
        dset = SyntheticBubbleDataset(img_size=args.img_size,
                                      data_size=args.iterations * args.batchsize)
    # every 10 iterations a new page to composite onto (train_BE_GAN.py:98-110)
    aug_pages = MangaPageDataset(args.aug_path) if args.aug_path else None
    if aug_pages is not None:
        print(f"aug stream: {len(aug_pages)} manga pages")
    aug_rng = np.random.default_rng(args.seed + 7)

    gs.g.model.train()
    gs.d.model.train()
    for epoch in range(start_epoch, args.epochs):
        it = device_batches(dset, args.batchsize, epoch, args.workers, device)
        acc, cnt, timer = None, 0, StepTimer()
        for i in range(args.iterations):
            if aug_pages is not None and i % 10 == 0 and isinstance(dset, BEGanDataset):
                dset.synthesis_target = aug_pages.load(int(aug_rng.integers(0, len(aug_pages))))
            try:
                batch = next(it)
            except StopIteration:
                it = device_batches(dset, args.batchsize, epoch * 7919 + i, args.workers, device)
                batch = next(it)
            gs, acc, cnt = astep(gs, acc, cnt, *batch)
            if (i + 1) % args.viz_freq == 0:
                avg = fetch_averages(acc, cnt)  # waits for the device
                timer.lap(args.viz_freq * args.batchsize)
                print(f"[epoch {epoch}] it {i + 1}: "
                      + " ".join(f"{k}={avg[k]:.6f}" for k in METRIC_KEYS)
                      + f" | {timer.items_per_sec:.1f} img/s")
                mlog.log(epoch * args.iterations + i + 1, {k: avg[k] for k in METRIC_KEYS},
                         epoch=epoch, images_per_sec=timer.items_per_sec)
                save_test_batch(batch[0], eval_step(batch[0]), args.res_output,
                                f"{epoch}_{i + 1}_wgtm")
        save_state(ckpt, epoch, gs)
        print(f"epoch {epoch} checkpoint -> {ckpt.path(epoch)}")
    return args.model_output


if __name__ == "__main__":
    main()
