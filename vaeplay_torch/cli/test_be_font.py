"""BE_font inference CLI -- port of vaeplay_tpu/cli/test_be_font.py (rebuild
of the reference test_BE_font.py): eval grids of both conditioning paths.

    python -m vaeplay_torch.cli.test_be_font --debug --gpu 0
    python -m vaeplay_torch.cli.test_be_font --model_path logs/BE_font/<timestamp> --gpu 0
    python -m vaeplay_torch.cli.test_be_font --model_path logs/BE_font/<timestamp>/0 --path KANA --gpu 0

Runs on `cuda:<--gpu>`; `--device cpu` runs on the CPU. Weights come from
`--model_path` (a train_be_font run dir, its latest checkpoint; `<run
dir>/<epoch>`; a checkpoint file, whose `g` entry is read; or a bare
state_dict with the reference's keys) or, with `--debug` alone, the seed-0
init; the net runs in eval mode (BatchNorm's running statistics). Without
`--path` one synthetic batch goes through both conditioning paths, the
labels' embeddings and the image's own style encodings, into one 7-row
font.png: images, true masks, masks with labels, masks self-encoded, true
edges, edges with labels, edges self-encoded. With `--path` every image of a
kana folder (KanaImageDataset), batch by batch, through the self-encoded
path only, into test_<i>.png: images, masks, edges.
"""

import argparse
import os
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
from PIL import Image

from vaeplay_torch.data.font_data import KanaImageDataset, SyntheticGlyphDataset
from vaeplay_torch.device import resolve_device
from vaeplay_torch.models.be_font import ComposeNet
from vaeplay_torch.train.checkpoint import load_model_path
from vaeplay_torch.train.steps_be_font import conditioning
from vaeplay_torch.utils.viz import makedirs, save_image_grid


def load_model(model_path, img_size: int, device: torch.device) -> ComposeNet:
    """ComposeNet on `device` in eval mode: weights from `model_path`
    (train/checkpoint.py:load_model_path; a FontState checkpoint's `g`) when
    given, else the seed-0 init. The load is strict."""
    model = ComposeNet(img_size, generator=torch.Generator().manual_seed(0))
    if model_path:
        saved = load_model_path(model_path)
        saved = saved.get("g", saved)
        model.load_state_dict(saved.get("model", saved))
    return model.to(device).eval()


@torch.no_grad()
def predict(model: ComposeNet, imgs: np.ndarray, device: torch.device,
            labels: Optional[np.ndarray] = None,
            styles: Optional[np.ndarray] = None) -> Dict[str, torch.Tensor]:
    """The sigmoid mask and edge maps (B, 1, S, S), on `device`, of NHWC
    float images: conditioned on labels and styles when given, else on the
    images' own style encodings."""
    x = torch.from_numpy(np.ascontiguousarray(imgs, np.float32)).to(device)
    x = x.permute(0, 3, 1, 2).contiguous()
    y = None
    if labels is not None:
        y = conditioning(torch.from_numpy(labels).to(device), torch.from_numpy(styles).to(device))
    return {k: torch.sigmoid(v) for k, v in model(x, y).items()}


def to_rgb(maps: torch.Tensor) -> np.ndarray:
    """(B, 1, S, S) maps -> NHWC (B, S, S, 3) on the host."""
    return np.repeat(maps.float().permute(0, 2, 3, 1).cpu().numpy(), 3, axis=-1)


def kana_batches(path: str, batch_size: int, img_size: int) -> Iterator[np.ndarray]:
    """A kana folder's images, binarized, white-padded and squared
    (KanaImageDataset), resized (nearest) to img_size, in NHWC batches."""
    dset = KanaImageDataset(path)
    if not len(dset):
        raise SystemExit(f"no images under {path}")
    for s in range(0, len(dset), batch_size):
        yield np.stack([np.asarray(dset.load(j).convert("RGB").resize(
            (img_size, img_size), Image.NEAREST), np.float32) / 255.0
            for j in range(s, min(s + batch_size, len(dset)))])


def main(argv=None) -> List[str]:
    """Run the CLI; returns the paths of the grids it wrote."""
    parser = argparse.ArgumentParser(description="BE_font inference (PyTorch/CUDA)")
    parser.add_argument("--path", type=str, dest="path", default=None,
                        help="kana crop folder: every image on the self-encoded style path "
                             "(default: one synthetic batch through both paths)")
    parser.add_argument("--model_path", type=str, dest="model_path", default=None,
                        help="a train_be_font run dir (its latest checkpoint), <run dir>/<epoch>, "
                             "a checkpoint file or a state_dict with the reference's keys")
    parser.add_argument("--debug", action="store_true", dest="debug")
    parser.add_argument("--gpu", type=int, dest="gpu", default=0)
    parser.add_argument("--device", type=str, dest="device", default=None,
                        choices=["cpu"], help="run on the CPU instead of --gpu")
    parser.add_argument("--img_size", type=int, dest="img_size", default=64)
    parser.add_argument("--batchsize", type=int, dest="batchsize", default=8)
    parser.add_argument("--res_output", type=str, dest="res_output",
                        default="./results/be_font_test")
    args = parser.parse_args(argv)
    if not args.debug and not args.model_path:
        parser.error("--model_path required unless --debug")
    device = resolve_device(args.gpu, args.device)
    makedirs(args.res_output)
    model = load_model(args.model_path, args.img_size, device)

    written = []
    if args.path:
        for i, imgs in enumerate(kana_batches(args.path, args.batchsize, args.img_size)):
            preds = predict(model, imgs, device)
            path = os.path.join(args.res_output, f"test_{i}.png")
            save_image_grid(np.concatenate([imgs, to_rgb(preds["masks"]),
                                            to_rgb(preds["edges"])]), path, nrow=len(imgs))
            print(f"wrote {path}")
            written.append(path)
        return written

    b = next(SyntheticGlyphDataset(data_size=args.batchsize).batches(args.batchsize,
                                                                        args.img_size))
    with_y = predict(model, b["imgs"], device, b["labels"], b["styles"])
    own = predict(model, b["imgs"], device)
    grid = np.concatenate([b["imgs"], np.repeat(b["masks"], 3, axis=-1), to_rgb(with_y["masks"]),
                           to_rgb(own["masks"]), np.repeat(b["edges"], 3, axis=-1),
                           to_rgb(with_y["edges"]), to_rgb(own["edges"])])
    path = os.path.join(args.res_output, "font.png")
    save_image_grid(grid, path, nrow=len(b["imgs"]))
    print(f"wrote {path}")
    return [path]


if __name__ == "__main__":
    main()
