"""BP data -- the port's own copy of the parts of vaeplay_tpu/data/bp_data.py
and be_data.py that the BP trainer and test_bp read (reference
datasets/dataset.py:185-191, 332-460). Pure numpy + PIL; for one seed the
synthetic batches are bit-identical to the JAX package's.

Training annotations (dataset.py:355-369) are JSON per image with
center_x/y, radius_x/y, step and `samples` rows [trigger, x, y, dx, dy,
length], one per half-degree sample (720); they are normalized to [-1, 1]
coordinates and x-scale radii as dataset.py:392-407 does. The model input
stacks [img, bmask, emask] as 3 channels (dataset.py:414).
"""

import json
import os
from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np
from PIL import Image

from vaeplay_torch.data.prefetch import batched_loads

SAMPLE_COUNT = 720


def decode_layer_mask(mask_rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """White pixels -> black, then ch0 = content mask, ch1 = edge mask
    (dataset.py:185-191). Input uint8 (H, W, 3); returns float32 (H, W) pairs
    scaled to [0, 1]."""
    m = mask_rgb.copy()
    bg = (m[:, :, 0] == 255) & (m[:, :, 1] == 255) & (m[:, :, 2] == 255)
    m[bg] = 0
    return m[:, :, 0].astype(np.float32) / 255.0, m[:, :, 1].astype(np.float32) / 255.0


class BPDataset:
    """Host loader for the reference's img/layer/ellipse/annotation layout."""

    def __init__(self, data_path: str, img_size: int):
        self.img_size = img_size
        self.items = []
        for name in sorted(os.listdir(os.path.join(data_path, "img"))):
            name = name.split(".")[0]
            self.items.append({
                "img": os.path.join(data_path, "img", f"{name}.png"),
                "layer": os.path.join(data_path, "layer", f"{name}.png"),
                "annotation": os.path.join(data_path, "annotation", f"{name}.txt"),
            })

    def __len__(self):
        return len(self.items)

    def load(self, idx: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(stacked image (S, S, 3), phase-1 params (5,), phase-2 rows (720, 6))."""
        it = self.items[idx]
        img = Image.open(it["img"]).convert("L")
        scale = 1.0 / img.height
        img = np.asarray(img.resize((self.img_size, self.img_size)), np.float32) / 255.0
        mask = Image.open(it["layer"]).convert("RGB").resize(
            (self.img_size, self.img_size), Image.NEAREST)
        bmask, emask = decode_layer_mask(np.asarray(mask))
        with open(it["annotation"]) as fp:
            a = json.load(fp)
        phase1 = np.array([
            (a["center_x"] * scale - 0.5) / 0.5,
            (a["center_y"] * scale - 0.5) / 0.5,
            a["radius_x"] * scale / 0.5,
            a["radius_y"] * scale / 0.5,
            a["step"],
        ], np.float32)
        phase2 = np.asarray(a["samples"], np.float32)
        phase2[:, 1] = (phase2[:, 1] * scale - 0.5) / 0.5
        phase2[:, 2] = (phase2[:, 2] * scale - 0.5) / 0.5
        phase2[:, 5] = phase2[:, 5] * scale / 0.5
        return np.stack([img, bmask, emask], axis=-1), phase1, phase2[:, :6]

    def epoch_batches(self, batch_size: int, seed: int = 0,
                      workers: int = 0) -> Iterator[Tuple]:
        """One epoch in a seeded random order; workers > 0 pools the per-sample
        decode and annotation parse (the reference's DataLoader workers)."""
        order = np.random.default_rng(seed).permutation(len(self))
        for items in batched_loads(self.load, order, batch_size, workers):
            imgs, p1, p2 = zip(*items)
            yield np.stack(imgs), np.stack(p1), np.stack(p2)


class BPDatasetTEST:
    """Test-time BP loader (dataset.py:421-460): class-3 `_mask2` bubble
    images + `_layer` masks stacked as [img, bmask, emask] channels."""

    def __init__(self, data_path: str, img_size: int):
        self.img_size = img_size
        self.items = []
        cls_folder = os.path.join(data_path, "3")
        if os.path.isdir(cls_folder):
            for patch in sorted(os.listdir(cls_folder)):
                if any(t in patch for t in ("layer", "mask", "edge", "bubble")):
                    continue
                name, ext = patch.split(".")[:2]
                self.items.append({
                    "img": os.path.join(cls_folder, f"{name}_mask2.{ext}"),
                    "mask": os.path.join(cls_folder, f"{name}_layer.{ext}"),
                })

    def __len__(self):
        return len(self.items)

    def load(self, idx: int) -> np.ndarray:
        it = self.items[idx]
        s = self.img_size
        img = np.asarray(
            Image.open(it["img"]).convert("L").resize((s, s), Image.NEAREST),
            np.float32) / 255.0
        mask = Image.open(it["mask"]).convert("RGB").resize((s, s), Image.NEAREST)
        bmask, emask = decode_layer_mask(np.asarray(mask))
        return np.stack([img, bmask, emask], axis=-1)


@dataclass
class SyntheticEmitDataset:
    """Procedural emit-line bubbles: an ellipse ring with radial lines every
    `step` samples. Produces ([img, bmask, emask] stacks, phase1, phase2)
    with the normalization contract of the reference BPDataset."""

    img_size: int = 128
    data_size: int = 512
    seed: int = 0

    def sample_batch(self, batch_size: int, batch_seed: int = 0):
        rng = np.random.default_rng((self.seed, batch_seed))
        n = self.img_size
        yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
        imgs = np.zeros((batch_size, n, n, 3), np.float32)
        p1s = np.zeros((batch_size, 5), np.float32)
        p2s = np.zeros((batch_size, SAMPLE_COUNT, 6), np.float32)
        ds = np.arange(SAMPLE_COUNT, dtype=np.float32)
        radians = ds / 2.0 * np.pi / 180.0
        for b in range(batch_size):
            cx, cy = rng.uniform(-0.3, 0.3, 2)
            rx, ry = rng.uniform(0.25, 0.55, 2)
            step = float(rng.integers(10, 40))
            length = rng.uniform(0.1, 0.3)
            # phase1 normalized params
            p1s[b] = [cx, cy, rx, ry, step]
            px = cx + rx * np.cos(radians)
            py = cy + ry * np.sin(radians)
            dpx = rx * -np.sin(radians)
            dpy = ry * np.cos(radians)
            l = np.sqrt(dpx**2 + dpy**2)
            dpx, dpy = dpy / l, -dpx / l  # outward normal
            trig = (ds % step == 0).astype(np.float32)
            p2s[b] = np.stack(
                [trig, px, py, dpx, dpy, np.full_like(ds, length)], axis=-1
            )
            # render: ellipse ring into emask+img, interior into bmask
            exn = (xx / (n - 1) - 0.5) / 0.5
            eyn = (yy / (n - 1) - 0.5) / 0.5
            d = ((exn - cx) / rx) ** 2 + ((eyn - cy) / ry) ** 2
            inside = d <= 1.0
            ring = (d <= 1.0) & (d >= 0.8)
            imgs[b, :, :, 0] = ring.astype(np.float32)
            imgs[b, :, :, 1] = inside.astype(np.float32)
            imgs[b, :, :, 2] = ring.astype(np.float32)
            # rasterize emit lines coarsely into channel 0
            sel = trig > 0
            for t in np.linspace(0, 1, 8):
                lx = px[sel] + dpx[sel] * length * t
                ly = py[sel] + dpy[sel] * length * t
                ix = np.clip(((lx * 0.5 + 0.5) * (n - 1)).astype(int), 0, n - 1)
                iy = np.clip(((ly * 0.5 + 0.5) * (n - 1)).astype(int), 0, n - 1)
                imgs[b, iy, ix, 0] = 1.0
        return imgs, p1s, p2s

    def epoch_batches(self, batch_size: int, seed: int = 0,
                      workers: int = 0) -> Iterator[Tuple]:
        """One epoch of seeded batches; `workers` is taken as BPDataset takes
        it and ignored (a batch is made in one vectorized call)."""
        for b in range(self.data_size // batch_size):
            yield self.sample_batch(batch_size, batch_seed=seed * 10_000 + b)
