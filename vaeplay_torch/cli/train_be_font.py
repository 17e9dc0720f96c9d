"""BE_font trainer CLI -- port of vaeplay_tpu/cli/train_be_font.py (rebuild
of the reference train_BE_font.py).

    python -m vaeplay_torch.cli.train_be_font --gpu 0
    python -m vaeplay_torch.cli.train_be_font --fonts_path GLYPHS --pages_json PAGES --gpu 0
    python -m vaeplay_torch.cli.train_be_font --dtype bfloat16 --gpu 0
    python -m vaeplay_torch.cli.train_be_font --resume logs/BE_font/<timestamp> --epoch 2 --gpu 0

Flags are the JAX CLI's (the reference's defaults, train_BE_font.py:226-240):
64 px, batch 32, one epoch of 64 iterations, 143 classes, three Adam(1e-4)
optimizers (the generator, its style encoder, the discriminator). Runs on
`cuda:<--gpu>`; `--device cpu` runs on the CPU (it raises without a card
otherwise). Weights start from the port's seeded init (G from `--seed`, D
from `--seed` + 1). Without `--fonts_path` and `--pages_json`, synthetic
kana-like glyphs composited onto synthetic pages; with both, FEDataset
glyphs onto ImageDatasetJson pages. Either way the host builds each batch
with PIL on a prefetch thread while the device runs the step before it
(`--workers` is taken and unused, as in the JAX CLI). `--dtype bfloat16`
runs both nets under bf16 autocast with f32 state (utils/amp.py). Each run
writes record.txt, metrics.jsonl and one checkpoint per epoch (the whole
FontState) into <model_output>/BE_font/<timestamp>/; `--resume` loads the
latest checkpoint of an earlier run dir, strictly, and goes on from the
epoch after it.
"""

import argparse
import os
import time
from datetime import datetime
from typing import Callable, Iterator

import numpy as np
import torch

from vaeplay_torch.data.font_data import (AugmentOperator, FEDataset, ImageDatasetJson,
                                          SyntheticGlyphDataset, prepare_synthesis_data,
                                          synthesis_batch)
from vaeplay_torch.data.prefetch import prefetch
from vaeplay_torch.device import resolve_device
from vaeplay_torch.models.be_font import ComposeNet, Discriminator
from vaeplay_torch.train.checkpoint import Checkpointer, make_run_dir, restore_state, save_state
from vaeplay_torch.train.metrics import accumulating, fetch_averages
from vaeplay_torch.train.state import FontState
from vaeplay_torch.train.steps_be_font import AVG_KEYS, make_be_font_train_step
from vaeplay_torch.utils.amp import resolve_dtype
from vaeplay_torch.utils.metrics_log import MetricsLogger
from vaeplay_torch.utils.profiling import StepTimer


def build_state(img_size: int, lr: float, seed: int, device: torch.device) -> FontState:
    """The seeded G (`seed`) and D (`seed` + 1) on `device`, with their three
    Adams."""
    g = ComposeNet(img_size, generator=torch.Generator().manual_seed(seed))
    d = Discriminator(img_size, generator=torch.Generator().manual_seed(seed + 1))
    return FontState.create(g.to(device), d.to(device), lr)


def device_batch(b: dict, device: torch.device) -> tuple:
    """A host batch (NHWC) as the step's (imgs, masks, edges, labels,
    styles): copied to `device`, then permuted to NCHW there."""
    nchw = lambda a: torch.from_numpy(a).to(device).permute(0, 3, 1, 2).contiguous()
    return (nchw(b["imgs"]), nchw(b["masks"]), nchw(b["edges"]),
            torch.from_numpy(b["labels"]).to(device), torch.from_numpy(b["styles"]).to(device))


def real_data_batches(fonts_path: str, pages_json: str, batch_size: int, img_size: int,
                      seed: int) -> Callable[[int], Iterator[dict]]:
    """The real-data path (the JAX CLI's _real_data_batches): an epoch's
    FEDataset glyphs in a seeded order, each batch composited onto one
    ImageDatasetJson page."""
    fe = FEDataset(fonts_path)
    pages = ImageDatasetJson(pages_json)
    augmentor = AugmentOperator()

    def gen(epoch: int) -> Iterator[dict]:
        rng = np.random.default_rng((seed, epoch))
        order = rng.permutation(len(fe))
        for i in range(0, (len(fe) // batch_size) * batch_size, batch_size):
            base_img, target = pages.load(int(rng.integers(0, len(pages))))
            imgs, masks, labels = zip(*(fe.load(j) for j in order[i:i + batch_size]))
            t_imgs, t_masks, t_edges, t_styles = prepare_synthesis_data(
                base_img, target, imgs, masks, augmentor, rng)
            yield synthesis_batch(t_imgs, t_masks, t_edges, labels, t_styles, img_size)

    return gen


def main(argv=None) -> str:
    """Run the trainer; returns its run dir (the checkpoints' directory)."""
    parser = argparse.ArgumentParser(description="BE_font (kana mask cGAN) trainer, PyTorch/CUDA")
    parser.add_argument("--lr", type=float, dest="lr", default=1e-4)
    parser.add_argument("--gpu", type=int, dest="gpu", default=0)
    parser.add_argument("--device", type=str, dest="device", default=None,
                        choices=["cpu"], help="run on the CPU instead of --gpu")
    parser.add_argument("--epoch", type=int, dest="epochs", default=1)
    parser.add_argument("--batchsize", type=int, dest="batchsize", default=32)
    parser.add_argument("--workers", type=int, dest="workers", default=0)
    parser.add_argument("--img_size", type=int, dest="img_size", default=64)
    parser.add_argument("--iterations", type=int, dest="iterations", default=64)
    parser.add_argument("--fonts_path", type=str, dest="fonts_path", default=None,
                        help="reference ./save_folder of rendered glyphs")
    parser.add_argument("--pages_json", type=str, dest="pages_json", default=None,
                        help="reference training_data.json page list")
    parser.add_argument("--res_output", type=str, dest="res_output", default="./results")
    parser.add_argument("--model_output", type=str, dest="model_output", default="./logs")
    parser.add_argument("--viz_freq", type=int, dest="viz_freq", default=20)
    parser.add_argument("--seed", type=int, dest="seed", default=0)
    parser.add_argument("--dtype", type=str, dest="dtype", default="float32",
                        choices=("float32", "f32", "bfloat16", "bf16"),
                        help="compute dtype of both nets' forward and backward; parameters, "
                             "optimizer state, BatchNorm buffers and losses stay f32")
    parser.add_argument("--resume", type=str, dest="resume", default=None,
                        help="run dir of a previous checkpoint to resume from")
    args = parser.parse_args(argv)
    device = resolve_device(args.gpu, args.device)
    cdtype = resolve_dtype(args.dtype)

    stamp = datetime.now().strftime("%Y%m%d-%H%M%S")
    args.res_output = make_run_dir(args.res_output, "BE_font", stamp)
    args.model_output = make_run_dir(args.model_output, "BE_font", stamp)
    with open(os.path.join(args.model_output, "record.txt"), "w") as f:
        for arg in vars(args):
            f.write("{:35}{:20}\n".format(arg, str(getattr(args, arg))))

    fs = build_state(args.img_size, args.lr, args.seed, device)
    start_epoch = 0
    if args.resume:
        fs, tag = restore_state(args.resume, fs)
        start_epoch = tag + 1
        print(f"resumed epoch {tag} from {args.resume}")
    astep = accumulating(make_be_font_train_step(fs.g.model, fs.d.model, cdtype))
    ckpt = Checkpointer(args.model_output)
    mlog = MetricsLogger(args.model_output)

    if args.fonts_path and args.pages_json:
        batches_fn = real_data_batches(args.fonts_path, args.pages_json, args.batchsize,
                                       args.img_size, args.seed)
    else:
        print("no --fonts_path/--pages_json; using synthetic glyph synthesis")
        ds = SyntheticGlyphDataset(data_size=args.iterations * args.batchsize, seed=args.seed)
        batches_fn = lambda epoch: ds.batches(args.batchsize, args.img_size, epoch)

    fs.g.model.train()
    fs.d.model.train()
    for epoch in range(start_epoch, args.epochs):
        acc, cnt, timer = None, 0, StepTimer()
        for i, b in enumerate(prefetch(batches_fn(epoch))):
            fs, acc, cnt = astep(fs, acc, cnt, *device_batch(b, device))
            if (i + 1) % args.viz_freq == 0:
                avg = fetch_averages(acc, cnt)  # waits for the device
                timer.lap(args.viz_freq * args.batchsize)
                print(f"Epoch [{epoch}][{i + 1}] " + " ".join(f"{k}={avg[k]:.6f}"
                                                             for k in AVG_KEYS)
                      + f" | {timer.items_per_sec:.1f} img/s")
                mlog.log(epoch * args.iterations + i + 1, {k: avg[k] for k in AVG_KEYS},
                         epoch=epoch, images_per_sec=timer.items_per_sec)
        t = time.perf_counter()
        path = save_state(ckpt, epoch, fs)
        print(f"epoch {epoch} checkpoint -> {path} ({os.path.getsize(path) / 2**30:.2f} GiB "
              f"in {time.perf_counter() - t:.1f} s)")
    return args.model_output


if __name__ == "__main__":
    main()
