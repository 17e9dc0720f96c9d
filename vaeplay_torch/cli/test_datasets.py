"""Dataset visual smoke-checks -- port of vaeplay_tpu/cli/test_datasets.py
(rebuild of the reference test_2_dataset.py:49-156).

    python -m vaeplay_torch.cli.test_datasets --gpu 0
    python -m vaeplay_torch.cli.test_datasets --out ./tests_viz --img_size 128 --device cpu

Renders one batch of every family's synthetic data into a PNG grid under
`--out`: circles.png (the circle VAE-GAN's, rendered on `cuda:<--gpu>`, or on
the CPU with `--device cpu`), be.png (image | mask | edge rows), bc.png
(contour targets drawn on the images), bp.png, bcp.png (the annotated points)
and font.png (glyph | mask | edge rows). 64 px is the smallest `--img_size`
the circles' minimum radius of 10 allows, as in the JAX CLI.
"""

import argparse
import os

import numpy as np
import torch

from vaeplay_torch.data.bc_data import SyntheticBCDataset
from vaeplay_torch.data.bcp_data import SyntheticBCPDataset
from vaeplay_torch.data.be_data import SyntheticBubbleDataset
from vaeplay_torch.data.bp_data import SyntheticEmitDataset
from vaeplay_torch.data.circles import CircleDataset
from vaeplay_torch.data.font_data import SyntheticGlyphDataset
from vaeplay_torch.device import resolve_device
from vaeplay_torch.eval.viz_points import draw_points
from vaeplay_torch.ops.geometry import render_circle_batch
from vaeplay_torch.utils.viz import makedirs, save_image_grid


def main(argv=None) -> str:
    """Write the six grids; returns the output directory."""
    parser = argparse.ArgumentParser(description="dataset visual smoke-checks, PyTorch/CUDA")
    parser.add_argument("--out", type=str, default="./tests_viz")
    parser.add_argument("--img_size", type=int, default=128)
    parser.add_argument("--batchsize", type=int, default=8)
    parser.add_argument("--gpu", type=int, dest="gpu", default=0)
    parser.add_argument("--device", type=str, dest="device", default=None,
                        choices=["cpu"], help="render the circles on the CPU instead of --gpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.gpu, args.device)
    makedirs(args.out)
    n, bs = args.img_size, args.batchsize

    pb = torch.from_numpy(next(CircleDataset(n=n, data_size=bs).epoch_batches(bs))).to(device)
    circles = render_circle_batch(n, pb[:, 0], pb[:, 1], pb[:, 2])  # (B, 1, n, n)
    circles = circles.permute(0, 2, 3, 1).cpu().numpy()
    save_image_grid(np.repeat(circles, 3, -1), os.path.join(args.out, "circles.png"), nrow=bs)

    be = SyntheticBubbleDataset(img_size=n).sample_batch(bs)
    save_image_grid(np.concatenate([
        be["imgs"], np.repeat(be["bimgs"], 3, -1), np.repeat(be["eimgs"], 3, -1)
    ]), os.path.join(args.out, "be.png"), nrow=bs)

    bc = SyntheticBCDataset(img_size=n, max_points=128).sample_batch(bs)
    panels = [draw_points(bc["imgs"][i], bc["tgt_pts"][i], (255, 0, 0),
                          valid=bc["tgt_mask"][i] > 0) for i in range(bs)]
    save_image_grid(np.stack(panels), os.path.join(args.out, "bc.png"), nrow=bs)

    imgs, _, _ = SyntheticEmitDataset(img_size=n).sample_batch(bs)
    save_image_grid(imgs, os.path.join(args.out, "bp.png"), nrow=bs)

    bcp = SyntheticBCPDataset(img_size=n, max_points=256).sample_batch(bs)
    panels = []
    for i in range(bs):
        px = (bcp["points"][i, :, 0] * 0.5 + 0.5) * n
        py = (bcp["points"][i, :, 1] * 0.5 + 0.5) * n
        panels.append(draw_points(bcp["imgs"][i], np.stack([px, py], -1),
                                  (255, 0, 0), valid=bcp["pmask"][i] > 0))
    save_image_grid(np.stack(panels), os.path.join(args.out, "bcp.png"), nrow=bs)

    fb = next(SyntheticGlyphDataset(data_size=bs).batches(bs, n))
    save_image_grid(np.concatenate([
        fb["imgs"], np.repeat(fb["masks"], 3, -1), np.repeat(fb["edges"], 3, -1)
    ]), os.path.join(args.out, "font.png"), nrow=bs)

    print(f"wrote dataset smoke-check grids to {args.out}/")
    return args.out


if __name__ == "__main__":
    main()
