"""BP inference CLI -- port of vaeplay_tpu/cli/test_bp.py (rebuild of the
reference test_BP.py): predicted ellipse + emit-line ray visualization.

    python -m vaeplay_torch.cli.test_bp --debug --gpu 0
    python -m vaeplay_torch.cli.test_bp --model_path bp.pt --path DATA --gpu 0
    python -m vaeplay_torch.cli.test_bp --model_path logs/BP/<timestamp> --gpu 0

Runs on `cuda:<--gpu>`; `--device cpu` runs on the CPU. `--model_path` reads
a `torch.save`d state_dict with the reference's key names, or a run dir of
`cli/train_bp.py`, whose latest checkpoint's model it loads (as the JAX CLI
reads its trainer's latest orbax checkpoint). Without `--path` it renders one
synthetic batch; with it, every class-3 test sample under the dataset root.
"""

import argparse
import os
from typing import Dict, List

import numpy as np
import torch

from vaeplay_torch.data.bp_data import BPDatasetTEST, SyntheticEmitDataset
from vaeplay_torch.device import resolve_device
from vaeplay_torch.eval.viz_points import draw_points, draw_rays
from vaeplay_torch.models.bp import ComposeNet
from vaeplay_torch.ops.losses import VALUE_WEIGHT
from vaeplay_torch.train.checkpoint import Checkpointer
from vaeplay_torch.utils.profiling import span
from vaeplay_torch.utils.viz import makedirs, save_image_grid

# Tensors of the reference state_dict with no counterpart in the port: the
# reference EllipseParamPredictor's conv stack is defined but never run
# (networks_BP.py:46-51, 62-66).
DEAD_KEY_PREFIXES = ("ellipse_predictor.convs.",)


def load_model(model_path, img_size: int, device: torch.device) -> ComposeNet:
    """ComposeNet on `device` in eval mode: weights from `model_path` (a
    state_dict file, or a trainer run dir: the model of its latest
    checkpoint) when given, else a random init from seed 0."""
    model = ComposeNet(image_size=img_size, generator=torch.Generator().manual_seed(0))
    if model_path and os.path.isdir(model_path):
        ckpt = Checkpointer(model_path)
        if ckpt.latest() is None:
            raise FileNotFoundError(f"no checkpoints found under {model_path}")
        model.load_state_dict(ckpt.restore(ckpt.latest())["model"])
    elif model_path:
        sd = torch.load(model_path, map_location="cpu", weights_only=True)
        sd = {k: v for k, v in sd.items() if not k.startswith(DEAD_KEY_PREFIXES)}
        model.load_state_dict(sd)
    return model.to(device).eval()


def predict(model: ComposeNet, imgs: np.ndarray, device: torch.device) -> Dict[str, torch.Tensor]:
    """One forward of NHWC float images (B, H, W, 3); outputs stay on `device`.
    The call is the span `infer.predict`, holding `data.h2d` (the images'
    copy from pageable memory) and `infer.forward`."""
    with span("infer.predict"), torch.inference_mode():
        with span("data.h2d"):
            x = torch.from_numpy(np.ascontiguousarray(imgs, np.float32)).to(device)
        with span("infer.forward"):
            return model(x)


def render_batch(preds: Dict[str, torch.Tensor], imgs: np.ndarray, path: str) -> None:
    """Input, ellipse samples and triggered emit rays side by side, one row
    per image."""
    n = imgs.shape[1]
    sample = preds["sample_infos"].cpu().numpy()  # (B, S, 6) in [-1,1] coords
    trig = preds["if_triggers"].cpu().numpy().argmax(-1).astype(bool)
    line = preds["line_params"].cpu().numpy()     # offsets x10, theta, len x10
    panels = []
    for i in range(imgs.shape[0]):
        base = np.asarray(imgs[i])
        px = (sample[i, :, 0] * 0.5 + 0.5) * n
        py = (sample[i, :, 1] * 0.5 + 0.5) * n
        starts = np.stack([px, py], -1)
        dirs = sample[i, :, 2:4]
        lengths = np.abs(line[i, :, 3]) / VALUE_WEIGHT * 0.5 * n
        p1 = draw_points(base, starts, color=(255, 0, 0))
        p2 = draw_rays(base, starts, dirs, lengths, trig[i])
        panels.extend([base, p1, p2])
    save_image_grid(np.stack(panels), path, nrow=3)
    print(f"wrote {path}")


def main(argv=None) -> List[str]:
    """Run the CLI; returns the paths of the images it wrote."""
    parser = argparse.ArgumentParser(description="BP inference (PyTorch/CUDA)")
    parser.add_argument("--path", type=str, dest="path", default=None,
                        help="dataset root -- walks every class-3 test sample "
                             "(reference test_BP.py full-dataset loop); "
                             "default: one synthetic batch")
    parser.add_argument("--model_path", type=str, dest="model_path", default=None,
                        help="torch.save'd state_dict with the reference's key names, "
                             "or a train_bp run dir (its latest checkpoint)")
    parser.add_argument("--debug", action="store_true", dest="debug")
    parser.add_argument("--gpu", type=int, dest="gpu", default=0)
    parser.add_argument("--device", type=str, dest="device", default=None,
                        choices=["cpu"], help="run on the CPU instead of --gpu")
    parser.add_argument("--img_size", type=int, dest="img_size", default=512)
    parser.add_argument("--batchsize", type=int, dest="batchsize", default=4)
    parser.add_argument("--res_output", type=str, dest="res_output",
                        default="./results/bp_test")
    args = parser.parse_args(argv)
    if not args.debug and not args.model_path:
        parser.error("--model_path required unless --debug")
    device = resolve_device(args.gpu, args.device)
    makedirs(args.res_output)
    model = load_model(args.model_path, args.img_size, device)

    written = []

    def run(imgs, name):
        path = os.path.join(args.res_output, f"{name}.png")
        render_batch(predict(model, imgs, device), imgs, path)
        written.append(path)

    if args.path:
        dset = BPDatasetTEST(args.path, args.img_size)
        if not len(dset):
            parser.error(f"no class-3 test samples under {args.path}")
        for s in range(0, len(dset), args.batchsize):
            idxs = range(s, min(s + args.batchsize, len(dset)))
            run(np.stack([dset.load(j) for j in idxs]), f"emit_{s // args.batchsize}")
    else:
        ds = SyntheticEmitDataset(img_size=args.img_size, data_size=args.batchsize)
        imgs, _, _ = ds.sample_batch(args.batchsize)
        run(imgs, "emit")
    return written


if __name__ == "__main__":
    main()
