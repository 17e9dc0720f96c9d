"""Manga-page inference with the BE_GAN generator -- port of
vaeplay_tpu/cli/test_be_gan_manga.py (rebuild of the reference
test_BE_GAN_manga.py, which runs test_BE_manga's pipeline on the G net).

    python -m vaeplay_torch.cli.test_be_gan_manga --path MANGA --anno_path ANNO \\
        --model_path logs/BE_GAN/<timestamp> --gpu 0

Loads G from a train_be_gan run dir (the generator of its latest
checkpoint, JAX :44-50; `<run dir>/<epoch>` picks an epoch, as test_be's
--model_path does) or `--debug`'s seed-0 init, and serves every annotated
page under --path through eval/serve.py:serve_pages with the bit-packed
predictor. Runs on `cuda:<--gpu>`; `--device cpu` runs on the CPU;
`--dtype bfloat16` runs the forward under bf16 autocast.
"""

import argparse

import torch

from vaeplay_torch.cli.test_be_manga import page_jobs
from vaeplay_torch.device import resolve_device
from vaeplay_torch.eval.predictor import make_packed_be_predict
from vaeplay_torch.eval.serve import ServeStats, serve_pages
from vaeplay_torch.models.be_gan import ComposeNet
from vaeplay_torch.train.checkpoint import load_model_path
from vaeplay_torch.utils.amp import resolve_dtype
from vaeplay_torch.utils.viz import makedirs


def load_generator(model_path, device: torch.device) -> ComposeNet:
    """G on `device` in eval mode: the "g" model of the GanState that
    model_path names (train/checkpoint.py:load_model_path), else the seed-0
    init."""
    model = ComposeNet(generator=torch.Generator().manual_seed(0))
    if model_path:
        model.load_state_dict(load_model_path(model_path)["g"]["model"])
    return model.to(device).eval()


def main(argv=None) -> ServeStats:
    """Run the CLI; returns (and prints) the ServeStats."""
    parser = argparse.ArgumentParser(description="manga-page inference with the BE_GAN "
                                                 "generator (PyTorch/CUDA)")
    parser.add_argument("--path", type=str, dest="path", required=True)
    parser.add_argument("--anno_path", type=str, dest="anno_path", required=True)
    parser.add_argument("--model_path", type=str, dest="model_path", default=None,
                        help="train_be_gan run dir (its latest checkpoint) or "
                             "<run dir>/<epoch>")
    parser.add_argument("--debug", action="store_true", dest="debug")
    parser.add_argument("--gpu", type=int, dest="gpu", default=0)
    parser.add_argument("--device", type=str, dest="device", default=None,
                        choices=["cpu"], help="run on the CPU instead of --gpu")
    parser.add_argument("--img_size", type=int, dest="img_size", default=512)
    parser.add_argument("--res_output", type=str, dest="res_output", default="./results/manga_gan")
    parser.add_argument("--dtype", type=str, dest="dtype", default="float32",
                        choices=("float32", "f32", "bfloat16", "bf16"))
    args = parser.parse_args(argv)
    if not args.debug and not args.model_path:
        parser.error("--model_path required unless --debug")
    device = resolve_device(args.gpu, args.device)
    makedirs(args.res_output)
    model = load_generator(None if args.debug else args.model_path, device)
    predict = make_packed_be_predict(model, args.img_size,
                                     compute_dtype=resolve_dtype(args.dtype))
    stats = serve_pages(predict, page_jobs(args.path, args.anno_path, annotated_only=True),
                        args.img_size, args.res_output)
    print(f"pages written {stats.written}, empty {stats.empty}, failed {stats.failed}")
    return stats


if __name__ == "__main__":
    main()
