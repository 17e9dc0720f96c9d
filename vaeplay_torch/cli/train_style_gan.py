"""Style_GAN trainer CLI -- port of vaeplay_tpu/cli/train_style_gan.py
(rebuild of the reference train_Style_GAN.py).

    python -m vaeplay_torch.cli.train_style_gan --gpu 0
    python -m vaeplay_torch.cli.train_style_gan --path DATA --gpu 0
    python -m vaeplay_torch.cli.train_style_gan --dtype bfloat16 --gpu 0
    python -m vaeplay_torch.cli.train_style_gan --resume logs/Style_GAN/<timestamp> --epochs 3

Flags are the JAX CLI's (the reference's defaults, train_Style_GAN.py:287-302):
256 px, z 512, batch 32, 2 epochs of 1000 iterations, 2 classes, three
Adam(1e-4) optimizers (E, G, D). Runs on `cuda:<--gpu>`; `--device cpu` runs
on the CPU (it raises without a card otherwise). Weights start from the
port's seeded init (E from `--seed`, G from `--seed` + 1, D from `--seed` +
2); the step's noise comes from a generator on the device seeded with
`--seed` + 3. Without `--path`, synthetic bubbles rendered on the device from
their parameter tables; with it, BEGanStyleDataset(path, select_list=(2, 3))
loaded on the host (`--workers` threads, a prefetch thread) and copied. The
content image is the bubble mask repeated to 3 channels, the label
`label % num_of_classes`.

Label bucketing (`--label_bucketing`, the default) is the JAX CLI's rule:
with 2 classes only, each batch is sorted label-0 first with capacities
rounded to `batchsize // 2`, and only the (B/2, B/2) bucket takes G's split
form; every other batch takes the blended one. A device-rendered batch is
sorted as its parameter table, before rendering. `--scan_steps K > 1`
(synthetic data only) runs the JAX CLI's chunked stream: batch seeds epoch
x 100003 + c K + k, the blended form, the K steps' metrics summed on the
device, logged at the chunk where `--viz_freq` falls. `--dtype bfloat16`
runs the three nets under bf16 autocast with f32 state (utils/amp.py). Each
run writes record.txt, metrics.jsonl and one checkpoint per epoch (the whole
StyleGanState) into <model_output>/Style_GAN/<timestamp>/, and no images, as
the JAX CLI writes none; `--resume` loads the latest checkpoint of an earlier
run dir, strictly, and goes on from the epoch after it.
"""

import argparse
import os
import time
from datetime import datetime
from typing import Iterator, Tuple

import numpy as np
import torch

from vaeplay_torch.data.be_data import (SyntheticBubbleDataset, render_bubble_batch,
                                        sample_bubble_params)
from vaeplay_torch.data.be_gan_data import BEGanStyleDataset
from vaeplay_torch.data.prefetch import epoch_iterator
from vaeplay_torch.device import resolve_device
from vaeplay_torch.models.style_gan import Discriminator, Generator, StyleEncoder
from vaeplay_torch.train.checkpoint import Checkpointer, make_run_dir, restore_state, save_state
from vaeplay_torch.train.metrics import accumulating, fetch_averages
from vaeplay_torch.train.state import StyleGanState
from vaeplay_torch.train.steps_style_gan import (AVG_KEYS, make_style_gan_train_step,
                                                 sort_batch_by_label)
from vaeplay_torch.utils.amp import resolve_dtype
from vaeplay_torch.utils.metrics_log import MetricsLogger
from vaeplay_torch.utils.profiling import StepTimer

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Tuple[int, int]]


def build_state(img_size: int, z_dim: int, num_classes: int, lr: float, seed: int,
                device: torch.device) -> StyleGanState:
    """The seeded E (`seed`), G (`seed` + 1) and D (`seed` + 2) on `device`,
    with their three Adams."""
    gen = lambda k: torch.Generator().manual_seed(seed + k)
    e = StyleEncoder(z_dim, img_size, generator=gen(0))
    g = Generator(img_size, z_dim, generator=gen(1))
    d = Discriminator(img_size, num_classes, generator=gen(2))
    return StyleGanState.create(e.to(device), g.to(device), d.to(device), lr)


class Bucketing:
    """The JAX CLI's label bucketing (cli/train_style_gan.py:105-132):
    sort(labels, *arrays) -> (arrays, labels, split), with split the (B/2,
    B/2) bucket or None (the blended form); with `enabled` False, or other
    than 2 classes, nothing is sorted and split is None."""

    def __init__(self, enabled: bool, num_classes: int, batch_size: int):
        self.enabled = enabled and num_classes == 2
        self.pad = max(1, batch_size // 2)
        self.allowed = (batch_size // 2, batch_size // 2)

    def sort(self, labels: np.ndarray, *arrays):
        if not self.enabled:
            return list(arrays), labels, None
        arrays, labels, split = sort_batch_by_label(labels, *arrays, pad=self.pad)
        return arrays, labels, split if split == self.allowed else None


def device_batches(dset, batch_size: int, seed: int, workers: int, num_classes: int,
                   bucketing: Bucketing, device: torch.device) -> Iterator[Batch]:
    """One epoch of (x_target, x_content, labels, split) on `device`: the
    synthetic bubbles rendered there from their (sorted) tables, the folder
    ones loaded on the host, sorted there and copied."""
    if isinstance(dset, SyntheticBubbleDataset):
        for params, raw in dset.epoch_params(batch_size, seed):
            yield render_batch(params, raw % num_classes, bucketing, dset.img_size, device)
    else:
        for b in epoch_iterator(dset, batch_size, seed, workers):
            (imgs, bimgs), labels, split = bucketing.sort(b["labels"] % num_classes,
                                                          b["imgs"], b["bimgs"])
            nchw = lambda a: torch.from_numpy(a).to(device).permute(0, 3, 1, 2).contiguous()
            yield (nchw(imgs), nchw(bimgs).expand(-1, 3, -1, -1).contiguous(),
                   torch.from_numpy(labels).to(device), split)


def render_batch(params: np.ndarray, labels: np.ndarray, bucketing: Bucketing, img_size: int,
                 device: torch.device) -> Batch:
    """A (B, 5) bubble table and its labels (sorted first, when bucketing
    applies) rendered on `device` as (x_target, x_content, labels, split)."""
    (params,), labels, split = bucketing.sort(labels, params)
    imgs, bimgs, _ = render_bubble_batch(img_size, torch.from_numpy(params).to(device))
    return (imgs, bimgs.expand(-1, 3, -1, -1).contiguous(),
            torch.from_numpy(np.asarray(labels, np.int64)).to(device), split)


def main(argv=None) -> str:
    """Run the trainer; returns its run dir (the checkpoints' directory)."""
    parser = argparse.ArgumentParser(description="Style_GAN (bubble style VAE-GAN) trainer, "
                                                 "PyTorch/CUDA")
    parser.add_argument("--path", type=str, dest="path", default=None)
    parser.add_argument("--lr", type=float, dest="lr", default=1e-4)
    parser.add_argument("--gpu", type=int, dest="gpu", default=0)
    parser.add_argument("--device", type=str, dest="device", default=None,
                        choices=["cpu"], help="run on the CPU instead of --gpu")
    parser.add_argument("--epochs", type=int, dest="epochs", default=2)
    parser.add_argument("--iterations", type=int, dest="iterations", default=1000)
    parser.add_argument("--batchsize", type=int, dest="batchsize", default=32)
    parser.add_argument("--workers", type=int, dest="workers", default=0)
    parser.add_argument("--img_size", type=int, dest="img_size", default=256)
    parser.add_argument("--z_dim", type=int, dest="z_dim", default=512)
    parser.add_argument("--num_of_classes", type=int, dest="num_of_classes", default=2)
    parser.add_argument("--res_output", type=str, dest="res_output", default="./results")
    parser.add_argument("--model_output", type=str, dest="model_output", default="./logs")
    parser.add_argument("--viz_freq", type=int, dest="viz_freq", default=50)
    parser.add_argument("--seed", type=int, dest="seed", default=0)
    parser.add_argument("--dtype", type=str, dest="dtype", default="float32",
                        choices=("float32", "f32", "bfloat16", "bf16"),
                        help="compute dtype of the three nets' forward and backward; "
                             "parameters, optimizer state and losses stay f32")
    parser.add_argument("--resume", type=str, dest="resume", default=None,
                        help="run dir of a previous checkpoint to resume from")
    parser.add_argument("--scan_steps", type=int, dest="scan_steps", default=1,
                        help="K > 1 (synthetic data only): the JAX CLI's chunked batch stream, "
                             "K steps a chunk, their metrics summed on the device")
    parser.add_argument("--label_bucketing", dest="label_bucketing", default=True,
                        action=argparse.BooleanOptionalAction,
                        help="sort each batch by label; a (B/2, B/2) batch runs each gated "
                             "conv branch only on its rows (exact; 2 classes only)")
    args = parser.parse_args(argv)
    device = resolve_device(args.gpu, args.device)
    cdtype = resolve_dtype(args.dtype)

    stamp = datetime.now().strftime("%Y%m%d-%H%M%S")
    args.res_output = make_run_dir(args.res_output, "Style_GAN", stamp)
    args.model_output = make_run_dir(args.model_output, "Style_GAN", stamp)
    with open(os.path.join(args.model_output, "record.txt"), "w") as f:
        for arg in vars(args):
            f.write("{:35}{:20}\n".format(arg, str(getattr(args, arg))))

    ss = build_state(args.img_size, args.z_dim, args.num_of_classes, args.lr, args.seed, device)
    start_epoch = 0
    if args.resume:
        ss, tag = restore_state(args.resume, ss)
        start_epoch = tag + 1
        print(f"resumed epoch {tag} from {args.resume}")
    noise = torch.Generator(device=device).manual_seed(args.seed + 3)
    astep = accumulating(make_style_gan_train_step(ss.e.model, ss.g.model, ss.d.model,
                                                   args.z_dim, cdtype, noise))
    bucketing = Bucketing(args.label_bucketing, args.num_of_classes, args.batchsize)
    ckpt = Checkpointer(args.model_output)
    mlog = MetricsLogger(args.model_output)

    if args.path:
        dset = BEGanStyleDataset(args.path, args.img_size, select_list=(2, 3))
    else:
        print("no --path given; using the synthetic bubble dataset, rendered on the device")
        dset = SyntheticBubbleDataset(img_size=args.img_size,
                                      data_size=args.iterations * args.batchsize)
    scan = args.scan_steps > 1 and not args.path
    blended = Bucketing(False, args.num_of_classes, args.batchsize)

    def log(epoch: int, done: int, acc, cnt: int, timer: StepTimer, images: int) -> None:
        avg = fetch_averages(acc, cnt)  # waits for the device
        timer.lap(images)
        print(f"[epoch {epoch}] it {done}: " + " ".join(f"{k}={avg[k]:.6f}" for k in AVG_KEYS)
              + f" | {timer.items_per_sec:.1f} img/s")
        mlog.log(epoch * args.iterations + done, {k: avg[k] for k in AVG_KEYS}, epoch=epoch,
                 images_per_sec=timer.items_per_sec)

    for m in (ss.e.model, ss.g.model, ss.d.model):
        m.train()
    for epoch in range(start_epoch, args.epochs):
        acc, cnt, timer = None, 0, StepTimer()
        if scan:
            k_steps, logged = args.scan_steps, 0
            for c in range(args.iterations // k_steps):
                for k in range(k_steps):
                    params, raw = sample_bubble_params(
                        args.img_size, args.batchsize, seed=args.seed,
                        batch_seed=epoch * 100003 + c * k_steps + k)
                    *batch, _ = render_batch(params, raw % args.num_of_classes, blended,
                                             args.img_size, device)
                    ss, acc, cnt = astep(ss, acc, cnt, *batch)
                done = (c + 1) * k_steps
                if done % args.viz_freq < k_steps:
                    log(epoch, done, acc, cnt, timer, (done - logged) * args.batchsize)
                    logged = done
        else:
            it = device_batches(dset, args.batchsize, epoch, args.workers, args.num_of_classes,
                                bucketing, device)
            for i in range(args.iterations):
                try:
                    batch = next(it)
                except StopIteration:
                    it = device_batches(dset, args.batchsize, epoch * 7919 + i, args.workers,
                                        args.num_of_classes, bucketing, device)
                    batch = next(it)
                ss, acc, cnt = astep(ss, acc, cnt, *batch)
                if (i + 1) % args.viz_freq == 0:
                    log(epoch, i + 1, acc, cnt, timer, args.viz_freq * args.batchsize)
        t = time.perf_counter()
        path = save_state(ckpt, epoch, ss)
        print(f"epoch {epoch} checkpoint -> {path} ({os.path.getsize(path) / 2**30:.2f} GiB "
              f"in {time.perf_counter() - t:.1f} s)")
    return args.model_output


if __name__ == "__main__":
    main()
