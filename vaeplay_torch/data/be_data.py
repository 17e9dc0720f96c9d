"""BE data -- the port's own copy of vaeplay_tpu/data/be_data.py (rebuild of
the reference BEDataset/BTransform, datasets/dataset.py:105-199), plus the
bubble rasteriser on the device.

  * Host: the folder scan, PIL decode, NEAREST resize and the `_layer` mask
    decode (white -> black; ch0 content mask, ch1 edge mask), as NHWC numpy
    batches. The joint rotation/flip augmentation runs on the device
    (ops/warp.py), not per sample on loader workers.
  * sample_bubble_params / render_bubble_batch: procedural speech bubbles
    (a white page, a dark ellipse interior, a black ring boundary) with
    content and edge masks, as a parameter table rasterised on any device,
    NCHW. The table stays f64 and the distance test runs in f64, as the JAX
    package's host render (SyntheticBubbleDataset.sample_batch) does in
    numpy, so the two agree bit for bit (the JAX package's own device
    render runs in f32 and may differ on boundary pixels).
  * SyntheticBubbleDataset: those batches rendered on the CPU, NHWC numpy;
    the same batches for a seed as the JAX package's.
"""

import os
from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np
import torch
from PIL import Image

from vaeplay_torch.data.bp_data import decode_layer_mask
from vaeplay_torch.data.prefetch import batched_loads


class BEDataset:
    """Folder scanner of the reference layout: class dirs {1,2,3} for
    training, "test" for testing; each image pairs with `<name>_layer.<ext>`
    (dataset.py:155-175)."""

    def __init__(self, data_path: str, img_size: Tuple[int, int], if_test: bool = False):
        self.img_size = img_size  # (w, h)
        self.if_test = if_test
        self.imgs: List[str] = []
        self.masks: List[str] = []
        self.labels: List[int] = []
        wanted = ["test"] if if_test else ["1", "2", "3"]
        for cls_name in sorted(os.listdir(data_path)):
            if cls_name not in wanted:
                continue
            cls_folder = os.path.join(data_path, cls_name)
            for patch in sorted(os.listdir(cls_folder)):
                if any(tag in patch for tag in ("layer", "mask", "edge", "bubble")):
                    continue
                name, ext = patch.split(".")[:2]
                self.imgs.append(os.path.join(cls_folder, f"{name}.{ext}"))
                if not if_test:
                    self.masks.append(os.path.join(cls_folder, f"{name}_layer.{ext}"))
                    self.labels.append(int(cls_name))

    def __len__(self) -> int:
        return len(self.imgs)

    def load(self, idx: int):
        """(img (H, W, 3) f32, bimg (H, W, 1), eimg (H, W, 1), label); the
        last three are None for the test split."""
        w, h = self.img_size
        img = Image.open(self.imgs[idx]).convert("RGB").resize((w, h), Image.NEAREST)
        img = np.asarray(img, dtype=np.float32) / 255.0
        if self.if_test:
            return img, None, None, None
        mask = Image.open(self.masks[idx]).convert("RGB").resize((w, h), Image.NEAREST)
        bimg, eimg = decode_layer_mask(np.asarray(mask))
        return img, bimg[..., None], eimg[..., None], self.labels[idx]

    def epoch_batches(self, batch_size: int, seed: int = 0, workers: int = 0) -> Iterator[dict]:
        """One epoch in a seeded order, a last partial batch dropped; workers
        > 0 decodes on a thread pool (the reference's DataLoader workers,
        train_BE.py:115-121), with the same batches."""
        order = np.random.default_rng(seed).permutation(len(self))
        for items in batched_loads(self.load, order, batch_size, workers):
            imgs, bimgs, eimgs, labels = zip(*items)
            yield {"imgs": np.stack(imgs), "bimgs": np.stack(bimgs), "eimgs": np.stack(eimgs),
                   "labels": np.asarray(labels, np.int64)}


def sample_bubble_params(img_size: int, batch_size: int, seed: int = 0,
                         batch_seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """SyntheticBubbleDataset.sample_batch's rng stream as (params (B, 5)
    [cx, cy, rx, ry, gray] f64, labels (B,) int64): a batch is 40 bytes a
    sample to copy, not 5 x 4 x S^2."""
    rng = np.random.default_rng((seed, batch_seed))
    labels = rng.integers(1, 4, size=batch_size)
    params = np.zeros((batch_size, 5), np.float64)
    for i in range(batch_size):
        cx, cy = rng.uniform(0.3 * img_size, 0.7 * img_size, size=2)
        rx, ry = rng.uniform(0.15 * img_size, 0.3 * img_size, size=2)
        params[i] = (cx, cy, rx, ry, rng.uniform(0.0, 0.4))
    return params, labels.astype(np.int64)


def render_bubble_batch(img_size: int, params: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, 5) f64 params on a device -> (imgs (B, 3, S, S), bimgs (B, 1, S,
    S), eimgs (B, 1, S, S)) f32 there: the host render's f64 distance test
    on f32 pixel coordinates, its values rounded to f32."""
    n = img_size
    p = params.to(torch.float64)
    coords = torch.arange(n, dtype=torch.float32, device=p.device).to(torch.float64)
    dx = (coords.view(1, 1, n) - p[:, 0, None, None]) / p[:, 2, None, None]
    dy = (coords.view(1, n, 1) - p[:, 1, None, None]) / p[:, 3, None, None]
    d = dx * dx + dy * dy
    inside = d <= 1.0
    ring = inside & (d >= 0.75)
    gray = p[:, 4, None, None].to(torch.float32)
    img = torch.where(ring, 0.0, torch.where(inside, gray, 1.0))
    return (img[:, None].expand(-1, 3, -1, -1).contiguous(), inside[:, None].float(),
            ring[:, None].float())


@dataclass
class SyntheticBubbleDataset:
    """Procedural speech-bubble batches: white page, dark elliptical bubble
    interiors (content mask) with a ring boundary (edge mask), NHWC numpy;
    the stand-in for the reference's private manga crops."""

    img_size: int = 128
    data_size: int = 1024
    seed: int = 0

    def sample_batch(self, batch_size: int, batch_seed: int = 0) -> dict:
        """imgs (B, S, S, 3), bimgs and eimgs (B, S, S, 1), labels (B,):
        sample_bubble_params' table rendered by render_bubble_batch on the
        CPU, NHWC."""
        table, labels = sample_bubble_params(self.img_size, batch_size, self.seed, batch_seed)
        imgs, bimgs, eimgs = (t.permute(0, 2, 3, 1).contiguous().numpy()
                              for t in render_bubble_batch(self.img_size, torch.from_numpy(table)))
        return {"imgs": imgs, "bimgs": bimgs, "eimgs": eimgs, "labels": labels}

    def epoch_batches(self, batch_size: int, seed: int = 0, workers: int = 0) -> Iterator[dict]:
        """One epoch of seeded batches; `workers` is taken as BEDataset takes
        it and ignored (a batch is made in one call)."""
        for b in range(self.data_size // batch_size):
            yield self.sample_batch(batch_size, batch_seed=seed * 10_000 + b)

    def epoch_params(self, batch_size: int, seed: int = 0) -> Iterator[Tuple[np.ndarray,
                                                                            np.ndarray]]:
        """epoch_batches' batches as sample_bubble_params tables, for
        render_bubble_batch on the device."""
        for b in range(self.data_size // batch_size):
            yield sample_bubble_params(self.img_size, batch_size, self.seed,
                                       seed * 10_000 + b)
