"""BCP inference CLI -- port of vaeplay_tpu/cli/test_bcp.py (rebuild of the
reference test_BCP.py): each image's contour, traced from its content mask
on the host, and the predicted emit points (contour + offset where the
trigger probability is above 0.5), drawn on the input.

    python -m vaeplay_torch.cli.test_bcp --debug --gpu 0
    python -m vaeplay_torch.cli.test_bcp --model_path logs/BCP/<timestamp> --gpu 0
    python -m vaeplay_torch.cli.test_bcp --model_path logs/BCP/<timestamp>/0 --path DATA --gpu 0

Runs on `cuda:<--gpu>`; `--device cpu` runs on the CPU. Weights come from
`--model_path` (a train_bcp run dir, its latest checkpoint; `<run
dir>/<epoch>`; a checkpoint file, whose `g` entry is read; or a bare
state_dict with the reference's keys) or, with `--debug` alone, the seed-0
init. As in the JAX CLI, G is built without point attention; the load is
strict, so a checkpoint of `train_bcp --point_attention` raises rather than
lose its attention blocks. Without
`--path` one synthetic batch is drawn; with it, every class-2/3 test sample
of a BCPDatasetTEST tree, batch by batch. The contours are traced from
channel 1 of the host batch before it is copied to the device
(networks_BCP.py:277-289). Each batch writes a grid of base, contour (red)
and predicted (green) panels, three to a row.
"""

import argparse
import os
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from vaeplay_torch.data.bcp_data import BCPDatasetTEST, SyntheticBCPDataset
from vaeplay_torch.device import resolve_device
from vaeplay_torch.eval.viz_points import draw_points
from vaeplay_torch.models.bcp import VALUE_WEIGHT, ComposeNet, eval_contours_from_masks
from vaeplay_torch.train.checkpoint import load_model_path
from vaeplay_torch.utils.viz import makedirs, save_image_grid


def load_model(model_path, max_points: int, device: torch.device) -> ComposeNet:
    """ComposeNet on `device` in eval mode: weights from `model_path`
    (train/checkpoint.py:load_model_path; a GanState checkpoint's `g`) when
    given, else the seed-0 init."""
    model = ComposeNet(max_points, generator=torch.Generator().manual_seed(0))
    if model_path:
        saved = load_model_path(model_path)
        saved = saved.get("g", saved)
        model.load_state_dict(saved.get("model", saved))
    return model.to(device).eval()


@torch.no_grad()
def forward(model: ComposeNet, imgs: np.ndarray, pts: np.ndarray, counts: np.ndarray,
            device: torch.device) -> Dict[str, torch.Tensor]:
    """The forward of NHWC float images (B, H, W, 3) at their traced contours
    (eval_contours_from_masks), all copied to `device`."""
    x = torch.from_numpy(np.ascontiguousarray(imgs, np.float32)).permute(0, 3, 1, 2)
    return model(x.contiguous().to(device), torch.from_numpy(pts).to(device),
                 torch.from_numpy(counts).to(device))


def predict(model: ComposeNet, imgs: np.ndarray, device: torch.device) -> Dict[str, torch.Tensor]:
    """Trace the contours of the host batch, then the forward."""
    return forward(model, imgs, *eval_contours_from_masks(imgs, model.line_predictor.pt_size),
                   device)


def render_batch(imgs: np.ndarray, preds: Dict[str, torch.Tensor], path: str) -> None:
    pts, counts, offs, freq = (preds[k].float().cpu().numpy() for k in
                               ("contours", "contour_counts", "target_pts", "target_frequency"))
    n = imgs.shape[1]
    to_px = lambda a: (a * 0.5 + 0.5) * n
    panels = []
    for i, base in enumerate(imgs):
        valid = np.arange(pts.shape[1]) < counts[i]
        panels += [base, draw_points(base, to_px(pts[i]), color=(255, 0, 0), valid=valid),
                   draw_points(base, to_px(pts[i] + offs[i] / VALUE_WEIGHT), color=(0, 255, 0),
                               valid=valid & (freq[i] > 0.5))]
    save_image_grid(np.stack(panels), path, nrow=3)


def host_batches(args) -> Iterator[Tuple[np.ndarray, str]]:
    if args.path:
        dset = BCPDatasetTEST(args.path, args.img_size)
        if not len(dset):
            raise SystemExit(f"no class-2/3 test samples under {args.path}")
        for s in range(0, len(dset), args.batchsize):
            idxs = range(s, min(s + args.batchsize, len(dset)))
            yield np.stack([dset.load(j) for j in idxs]), f"points_{s // args.batchsize}"
    else:
        ds = SyntheticBCPDataset(img_size=args.img_size, max_points=args.max_points,
                                 data_size=args.batchsize)
        yield ds.sample_batch(args.batchsize)["imgs"], "points"


def main(argv=None) -> List[str]:
    """Run the CLI; returns the paths of the grids it wrote."""
    parser = argparse.ArgumentParser(description="BCP inference (PyTorch/CUDA)")
    parser.add_argument("--path", type=str, dest="path", default=None,
                        help="dataset root: every class-2/3 test sample (default: one "
                             "synthetic batch)")
    parser.add_argument("--model_path", type=str, dest="model_path", default=None,
                        help="a train_bcp run dir (its latest checkpoint), <run dir>/<epoch>, "
                             "a checkpoint file or a state_dict with the reference's keys")
    parser.add_argument("--debug", action="store_true", dest="debug")
    parser.add_argument("--gpu", type=int, dest="gpu", default=0)
    parser.add_argument("--device", type=str, dest="device", default=None,
                        choices=["cpu"], help="run on the CPU instead of --gpu")
    parser.add_argument("--img_size", type=int, dest="img_size", default=512)
    parser.add_argument("--max_points", type=int, dest="max_points", default=2048)
    parser.add_argument("--batchsize", type=int, dest="batchsize", default=4)
    parser.add_argument("--res_output", type=str, dest="res_output", default="./results/bcp_test")
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
