"""BC inference CLI -- port of vaeplay_tpu/cli/test_bc.py (rebuild of the
reference test_BC.py): each image's traced contour points and the refined
ones (traced + regression), drawn on the input (test_BC.py:35-85).

    python -m vaeplay_torch.cli.test_bc --debug --gpu 0
    python -m vaeplay_torch.cli.test_bc --model_path logs/BC/<timestamp> --gpu 0
    python -m vaeplay_torch.cli.test_bc --model_path logs/BC/<timestamp>/3 --path DATA --gpu 0

Runs on `cuda:<--gpu>`; `--device cpu` runs on the CPU. Weights come from
`--model_path` (a train_bc run dir, its latest checkpoint; `<run
dir>/<epoch>`; a checkpoint file; or a bare state_dict with the reference's
keys) or, with `--debug` alone, the seed-0 init. Without `--path` one
synthetic batch is drawn; with it, every sample of a BCDataset tree, batch
by batch. The contours are traced inside the forward, on the host, between
the mask and the refine stages. Each batch writes a grid of base, traced
(red) and refined (green) panels, three to a row.
"""

import argparse
import os
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from vaeplay_torch.data.bc_data import BCDataset, SyntheticBCDataset
from vaeplay_torch.device import resolve_device
from vaeplay_torch.eval.viz_points import draw_points
from vaeplay_torch.models.bc import ComposeNet
from vaeplay_torch.train.checkpoint import load_model_path
from vaeplay_torch.utils.viz import makedirs, save_image_grid


def load_model(model_path, max_points: int, device: torch.device) -> ComposeNet:
    """ComposeNet (f32 refine FCs) on `device` in eval mode: weights from
    `model_path` (train/checkpoint.py:load_model_path; bf16 FCs load
    exactly) when given, else the seed-0 init."""
    model = ComposeNet(max_points, generator=torch.Generator().manual_seed(0))
    if model_path:
        saved = load_model_path(model_path)
        model.load_state_dict(saved.get("model", saved))
    return model.to(device).eval()


@torch.no_grad()
def predict(model: ComposeNet, imgs: np.ndarray, device: torch.device) -> Dict[str, torch.Tensor]:
    """The forward of NHWC float images (B, H, W, 3) on `device`, the
    contours traced inside it."""
    x = torch.from_numpy(np.ascontiguousarray(imgs, np.float32)).permute(0, 3, 1, 2)
    return model(x.contiguous().to(device))


def render_batch(imgs: np.ndarray, preds: Dict[str, torch.Tensor], path: str) -> None:
    cnts, regs, counts = (preds[k].cpu().numpy() for k in
                          ("contours", "contour_regressions", "contour_counts"))
    panels = []
    for i, base in enumerate(imgs):
        valid = np.arange(cnts.shape[1]) < counts[i]
        panels += [base, draw_points(base, cnts[i], color=(255, 0, 0), valid=valid),
                   draw_points(base, cnts[i] + regs[i], color=(0, 255, 0), valid=valid)]
    save_image_grid(np.stack(panels), path, nrow=3)


def host_batches(args) -> Iterator[Tuple[np.ndarray, str]]:
    if args.path:
        dset = BCDataset(args.path, (args.img_size, args.img_size), max_points=args.max_points,
                         if_test=True)
        if not len(dset):
            raise SystemExit(f"no test samples under {args.path}")
        for s in range(0, len(dset), args.batchsize):
            idxs = range(s, min(s + args.batchsize, len(dset)))
            yield np.stack([dset.load(j)[0] for j in idxs]), f"contours_{s // args.batchsize}"
    else:
        ds = SyntheticBCDataset(img_size=args.img_size, max_points=args.max_points,
                                data_size=args.batchsize)
        yield ds.sample_batch(args.batchsize)["imgs"], "contours"


def main(argv=None) -> List[str]:
    """Run the CLI; returns the paths of the grids it wrote."""
    parser = argparse.ArgumentParser(description="BC inference (PyTorch/CUDA)")
    parser.add_argument("--path", type=str, dest="path", default=None,
                        help="BCDataset root (default: one synthetic batch)")
    parser.add_argument("--model_path", type=str, dest="model_path", default=None,
                        help="a train_bc run dir (its latest checkpoint), <run dir>/<epoch>, "
                             "a checkpoint file or a state_dict with the reference's keys")
    parser.add_argument("--debug", action="store_true", dest="debug")
    parser.add_argument("--gpu", type=int, dest="gpu", default=0)
    parser.add_argument("--device", type=str, dest="device", default=None,
                        choices=["cpu"], help="run on the CPU instead of --gpu")
    parser.add_argument("--img_size", type=int, dest="img_size", default=256)
    parser.add_argument("--max_points", type=int, dest="max_points", default=256)
    parser.add_argument("--batchsize", type=int, dest="batchsize", default=8)
    parser.add_argument("--res_output", type=str, dest="res_output", default="./results/bc_test")
    args = parser.parse_args(argv)
    if not args.debug and not args.model_path:
        parser.error("--model_path required unless --debug")
    device = resolve_device(args.gpu, args.device)
    makedirs(args.res_output)
    model = load_model(args.model_path, args.max_points, device)

    written = []
    for imgs, name in host_batches(args):
        path = os.path.join(args.res_output, f"{name}.png")
        render_batch(imgs, predict(model, imgs, device), path)
        print(f"wrote {path}")
        written.append(path)
    return written


if __name__ == "__main__":
    main()
