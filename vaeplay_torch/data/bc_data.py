"""BC data -- the port's own copy of vaeplay_tpu/data/bc_data.py (rebuild of
the reference BCDataset, datasets/dataset.py:200-275), plus its synthetic
variant on the port's bubble render.

The targets are traced on the host, as the reference does once per sample
(dataset.py:242-254): the content mask is padded, its largest contour traced
by the port's native tracer (ops/contour.py), decimated to max_points, and
an RDP pass (epsilon 4) gives the key contour. Batches are NHWC numpy, with
fixed-capacity point arrays and validity masks.
"""

import os
from dataclasses import dataclass, field
from typing import Iterator, Tuple

import numpy as np
from PIL import Image

from vaeplay_torch.data.be_data import SyntheticBubbleDataset
from vaeplay_torch.data.bp_data import decode_layer_mask
from vaeplay_torch.data.prefetch import batched_loads
from vaeplay_torch.ops.contour import find_contour, rdp_simplify, resample_points

MAX_KEY_POINTS = 64


def contour_targets_from_mask(bimg01: np.ndarray, padding: int = 1, max_points: int = 256,
                              max_key_points: int = MAX_KEY_POINTS):
    """A mask (H, W) in [0, 1] -> (pts (max_points, 2) f32, n, key points
    (max_key_points, 2) f32, k): the padded full contour, decimated, and its
    RDP key points, zero past their counts. The reference traces the 0/255
    mask at level 0.8, as here."""
    padded = np.pad(bimg01 * 255.0, ((padding, padding), (padding, padding)))
    contour = find_contour(padded.astype(np.float32), level=0.8)
    key = rdp_simplify(contour, epsilon=4.0) if len(contour) else contour
    contour = resample_points(contour, max_points=max_points)
    pts = np.zeros((max_points, 2), np.float32)
    kpts = np.zeros((max_key_points, 2), np.float32)
    n = min(len(contour), max_points)
    k = min(len(key), max_key_points)
    if n:
        pts[:n] = contour[:n]
    if k:
        kpts[:k] = key[:k]
    return pts, n, kpts, k


def _valid(counts, capacity: int) -> np.ndarray:
    return (np.arange(capacity)[None, :] < np.asarray(counts)[:, None]).astype(np.float32)


class BCDataset:
    """Folder scanner of the reference layout: every class dir's images, each
    with `<name>_edge`, `<name>_mask` and `<name>_mask_edge` files; the
    model's input is the `_edge` image (dataset.py:224-227). `debug=N` stops
    the scan after N samples (dataset.py:228-233)."""

    def __init__(self, data_path: str, img_size: Tuple[int, int], padding: int = 1,
                 max_points: int = 256, if_test: bool = False, debug: int = -1):
        self.img_size = img_size  # (w, h)
        self.max_points = max_points
        self.padding = padding
        self.if_test = if_test
        self.imgs, self.bimgs, self.eimgs = [], [], []
        for cls_name in sorted(os.listdir(data_path)):
            cls_folder = os.path.join(data_path, cls_name)
            if not os.path.isdir(cls_folder):
                continue
            for patch in sorted(os.listdir(cls_folder)):
                if 0 < debug <= len(self.imgs):
                    return
                if any(t in patch for t in ("mask", "edge", "bubble")):
                    continue
                name, ext = patch.split(".")[:2]
                self.imgs.append(os.path.join(cls_folder, f"{name}_edge.{ext}"))
                self.bimgs.append(os.path.join(cls_folder, f"{name}_mask.{ext}"))
                self.eimgs.append(os.path.join(cls_folder, f"{name}_mask_edge.{ext}"))

    def __len__(self) -> int:
        return len(self.imgs)

    def load(self, idx: int):
        """(img (H, W, 3) f32, bimg (H, W, 1), eimg (H, W, 1), pts, n, kpts, k)."""
        w, h = self.img_size
        img = np.asarray(Image.open(self.imgs[idx]).convert("RGB").resize((w, h), Image.NEAREST),
                         np.float32) / 255.0

        def mask01(path):
            m = np.asarray(Image.open(path).convert("RGB").resize((w, h), Image.NEAREST))
            return decode_layer_mask(m)[0]

        bimg, eimg = mask01(self.bimgs[idx]), mask01(self.eimgs[idx])
        pts, n, kpts, k = contour_targets_from_mask(bimg, self.padding, self.max_points)
        return img, bimg[..., None], eimg[..., None], pts, n, kpts, k

    def epoch_batches(self, batch_size: int, seed: int = 0, workers: int = 0) -> Iterator[dict]:
        """One epoch in a seeded order, a last partial batch dropped; workers
        > 0 pools the decode and the target trace on threads."""
        order = np.random.default_rng(seed).permutation(len(self))
        for items in batched_loads(self.load, order, batch_size, workers):
            imgs, bimgs, eimgs, pts, ns, kpts, ks = zip(*items)
            yield {"imgs": np.stack(imgs), "bimgs": np.stack(bimgs), "eimgs": np.stack(eimgs),
                   "tgt_pts": np.stack(pts), "tgt_mask": _valid(ns, self.max_points),
                   "key_pts": np.stack(kpts), "key_mask": _valid(ks, MAX_KEY_POINTS)}


@dataclass
class SyntheticBCDataset:
    """Synthetic bubbles (data/be_data.py, the JAX package's batches for a
    seed) with contour targets from the loader's own host pipeline."""

    img_size: int = 128
    data_size: int = 512
    max_points: int = 256
    padding: int = 1
    seed: int = 0
    _bubbles: SyntheticBubbleDataset = field(init=False)

    def __post_init__(self):
        self._bubbles = SyntheticBubbleDataset(img_size=self.img_size, data_size=self.data_size,
                                               seed=self.seed)

    def sample_batch(self, batch_size: int, batch_seed: int = 0) -> dict:
        b = self._bubbles.sample_batch(batch_size, batch_seed)
        targets = [contour_targets_from_mask(m[:, :, 0], self.padding, self.max_points)
                   for m in b["bimgs"]]
        pts, ns, kpts, ks = zip(*targets)
        return {"imgs": b["imgs"], "bimgs": b["bimgs"], "eimgs": b["eimgs"],
                "tgt_pts": np.stack(pts), "tgt_mask": _valid(ns, self.max_points),
                "key_pts": np.stack(kpts), "key_mask": _valid(ks, MAX_KEY_POINTS)}

    def epoch_batches(self, batch_size: int, seed: int = 0, workers: int = 0) -> Iterator[dict]:
        """One epoch of seeded batches; `workers` is taken as BCDataset takes
        it and ignored."""
        for i in range(self.data_size // batch_size):
            yield self.sample_batch(batch_size, batch_seed=seed * 10_000 + i)
