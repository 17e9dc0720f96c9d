"""BP data for inference -- the port's own copy of the parts of
vaeplay_tpu/data/bp_data.py and be_data.py that test_bp reads (reference
datasets/dataset.py:185-191, 421-460). Pure numpy + PIL; for one seed the
synthetic batches are bit-identical to the JAX package's.

The model input stacks [img, bmask, emask] as 3 channels (dataset.py:414).
"""

import os
from dataclasses import dataclass
from typing import Tuple

import numpy as np
from PIL import Image

SAMPLE_COUNT = 720


def decode_layer_mask(mask_rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """White pixels -> black, then ch0 = content mask, ch1 = edge mask
    (dataset.py:185-191). Input uint8 (H, W, 3); returns float32 (H, W) pairs
    scaled to [0, 1]."""
    m = mask_rgb.copy()
    bg = (m[:, :, 0] == 255) & (m[:, :, 1] == 255) & (m[:, :, 2] == 255)
    m[bg] = 0
    return m[:, :, 0].astype(np.float32) / 255.0, m[:, :, 1].astype(np.float32) / 255.0


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
