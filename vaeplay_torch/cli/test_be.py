"""BE inference CLI -- port of vaeplay_tpu/cli/test_be.py (rebuild of the
reference test_BE.py): batched eval, inputs | masks | edges grids.

    python -m vaeplay_torch.cli.test_be --debug --gpu 0
    python -m vaeplay_torch.cli.test_be --model_path be.pt --path DATA --gpu 0
    python -m vaeplay_torch.cli.test_be --model_path logs/BE/<timestamp> --gpu 0

Runs on `cuda:<--gpu>`; `--device cpu` runs on the CPU. `--debug` builds an
untrained net (test_BE.py:71-75, seed 0); `--model_path` reads a
`torch.save`d state_dict with the reference's key names, or a run dir of
`cli/train_be.py`, whose latest checkpoint's model it loads. Without `--path`
it runs two synthetic batches; with it, every image of the "test" folder.
"""

import argparse
import os
from typing import Dict, Iterator, List

import numpy as np
import torch

from vaeplay_torch.data.be_data import BEDataset, SyntheticBubbleDataset
from vaeplay_torch.device import resolve_device
from vaeplay_torch.eval.be_eval import save_test_batch
from vaeplay_torch.models.be import ComposeNet
from vaeplay_torch.train.checkpoint import Checkpointer
from vaeplay_torch.train.steps_be import make_be_eval_step
from vaeplay_torch.utils.viz import makedirs


def load_model(model_path, device: torch.device) -> ComposeNet:
    """ComposeNet on `device` in eval mode: weights from `model_path` (a
    state_dict file, or a trainer run dir: the model of its latest
    checkpoint) when given, else the seed-0 init."""
    model = ComposeNet(generator=torch.Generator().manual_seed(0))
    if model_path and os.path.isdir(model_path):
        ckpt = Checkpointer(model_path)
        if ckpt.latest() is None:
            raise FileNotFoundError(f"no checkpoints found under {model_path}")
        model.load_state_dict(ckpt.restore(ckpt.latest())["model"])
    elif model_path:
        model.load_state_dict(torch.load(model_path, map_location="cpu", weights_only=True))
    return model.to(device).eval()


def to_nchw(imgs: np.ndarray, device: torch.device) -> torch.Tensor:
    """NHWC float images (B, H, W, 3) -> (B, 3, H, W) f32 on `device`."""
    x = torch.from_numpy(np.ascontiguousarray(imgs, np.float32)).permute(0, 3, 1, 2)
    return x.contiguous().to(device)


def predict(model: ComposeNet, imgs: np.ndarray, device: torch.device) -> Dict[str, torch.Tensor]:
    """The sigmoid mask and edge maps (B, 1, H, W) of NHWC images, on
    `device`: make_be_eval_step's."""
    return make_be_eval_step(model)(to_nchw(imgs, device))


def host_batches(args) -> Iterator[np.ndarray]:
    if args.path:
        dset = BEDataset(args.path, (args.img_size, args.img_size), if_test=True)
        for s in range(0, len(dset), args.batchsize):
            yield np.stack([dset.load(j)[0] for j in range(s, min(s + args.batchsize, len(dset)))])
    else:
        ds = SyntheticBubbleDataset(img_size=args.img_size, data_size=args.batchsize * 2)
        for batch in ds.epoch_batches(args.batchsize):
            yield batch["imgs"]


def main(argv=None) -> List[str]:
    """Run the CLI; returns the paths of the grids it wrote."""
    parser = argparse.ArgumentParser(description="BE inference (PyTorch/CUDA)")
    parser.add_argument("--path", type=str, dest="path", default=None,
                        help="dataset root; its \"test\" folder is run (default: two "
                             "synthetic batches)")
    parser.add_argument("--model_path", type=str, dest="model_path", default=None,
                        help="torch.save'd state_dict with the reference's key names, "
                             "or a train_be run dir (its latest checkpoint)")
    parser.add_argument("--debug", action="store_true", dest="debug")
    parser.add_argument("--gpu", type=int, dest="gpu", default=0)
    parser.add_argument("--device", type=str, dest="device", default=None,
                        choices=["cpu"], help="run on the CPU instead of --gpu")
    parser.add_argument("--img_size", type=int, dest="img_size", default=512)
    parser.add_argument("--batchsize", type=int, dest="batchsize", default=8)
    parser.add_argument("--res_output", type=str, dest="res_output", default="./results/be_test")
    args = parser.parse_args(argv)
    if not args.debug and not args.model_path:
        parser.error("--model_path required unless --debug")
    device = resolve_device(args.gpu, args.device)
    makedirs(args.res_output)
    model = load_model(None if args.debug else args.model_path, device)

    written = []
    for i, imgs in enumerate(host_batches(args)):
        path = save_test_batch(to_nchw(imgs, torch.device("cpu")), predict(model, imgs, device),
                               args.res_output, f"test_{i}")
        print(f"batch {i} -> {path}")
        written.append(path)
    return written


if __name__ == "__main__":
    main()
