"""BCP data -- the port's own copy of vaeplay_tpu/data/bcp_data.py (rebuild of
the reference BCPDataset, datasets/dataset.py:511-688), plus its synthetic
variant on the port's emit-line generator. Host numpy and PIL; for one seed
the batches equal the JAX package's.

Per sample: the layers/masks/annotations triple, annotation points [sx, sy,
ex, ey, freq, key] in pixels; the same rotation (+-15 degrees) and random
offset on the image and the points, shared vertical and horizontal flips,
the out-of-frame filter, endpoints turned into offsets, and a key-preserving
decimation to max_points (dataset.py:546-639). Batches hold NHWC images,
labels, fixed-capacity (P, 6) points and (P,) validity masks.
"""

import json
import os
from dataclasses import dataclass
from typing import Iterator

import numpy as np
from PIL import Image

from vaeplay_torch.data.be_gan_data import random_offset
from vaeplay_torch.data.bp_data import SyntheticEmitDataset, decode_layer_mask
from vaeplay_torch.data.prefetch import batched_loads


def resample_points_with_constraint(contour: np.ndarray, max_points: int,
                                    rng: np.random.Generator) -> np.ndarray:
    """Key-preserving random decimation (dataset.py:494-508): every key point
    (column 5 >= 0.9) stays, and a random subset of the rest fills up to
    max_points, in the original order."""
    if len(contour) > max_points:
        fix = contour[:, 5] >= 0.9
        rest = np.where(~fix)[0]
        idx = rng.permutation(len(rest))[:max(max_points - int(fix.sum()), 0)]
        fix[rest[idx]] = True
        return contour[fix]
    return contour


def mask_bbox(mask: np.ndarray):
    """PIL's Image.getbbox on an (H, W) array: (left, upper, right, lower) of
    the nonzero region, right and lower exclusive, or None."""
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return None
    return int(xs.min()), int(ys.min()), int(xs.max()) + 1, int(ys.max()) + 1


def affine_nearest_np(img: np.ndarray, rot_rad: float, ox: float, oy: float,
                      fill: float = 0.0) -> np.ndarray:
    """Nearest-neighbour affine warp of (H, W, C) on the host: rotation about
    the centre (w / 2, h / 2) by rot_rad with the point map R = [[cos, -sin],
    [sin, cos]], then a shift by (ox, oy), so the warped pixels land where the
    transformed annotation points do (dataset.py:583-605)."""
    h, w = img.shape[:2]
    cx, cy = w * 0.5, h * 0.5
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    dx, dy = xs - cx - ox, ys - cy - oy
    c, s = np.cos(rot_rad), np.sin(rot_rad)
    xi = np.rint(c * dx + s * dy + cx).astype(np.int64)  # the inverse rotation
    yi = np.rint(-s * dx + c * dy + cy).astype(np.int64)
    inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    out = img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)].copy()
    out[~inb] = fill
    return out


def augment_points_sample(img: np.ndarray, points: np.ndarray, max_points: int,
                          rng: np.random.Generator, rotate: bool = True):
    """The joint augmentation of one sample (dataset.py:540-639): img (H, W,
    3) [img, bmask, emask], points (N, 6) in pixels -> (img, points (M, 6)
    with [sx, sy] normalized to [-1, 1] and [dx, dy] the normalized offsets).
    As in the reference, the affine, rotation included, applies only when
    the random offset is nonzero (dataset.py:575-605)."""
    h, w = img.shape[:2]
    points = points.astype(np.float32).copy()
    rot = (rng.uniform(-15, 15) if rotate else 0.0) * np.pi / 180.0
    cx, cy = w * 0.5, h * 0.5
    bbox = mask_bbox(img[..., 0] > 0)
    ox, oy = random_offset(bbox, h, rng) if bbox is not None else (0, 0)
    if ox != 0 or oy != 0:
        img = affine_nearest_np(img, rot, float(ox), float(oy))
        if rotate:
            xs, ys = points[:, 0:3:2] - cx, points[:, 1:4:2] - cy
            points[:, 0:3:2] = xs * np.cos(rot) - ys * np.sin(rot) + cx
            points[:, 1:4:2] = xs * np.sin(rot) + ys * np.cos(rot) + cy
        points[:, 0:3:2] += ox
        points[:, 1:4:2] += oy
    points[:, :4] = (points[:, :4] * (1.0 / h) - 0.5) / 0.5
    if rng.random() < 0.5:
        img = img[::-1].copy()
        points[:, 1:4:2] *= -1
    if rng.random() < 0.5:
        img = img[:, ::-1].copy()
        points[:, 0:3:2] *= -1
    if rotate:
        keep = ((np.abs(points[:, 0]) <= 1) | (np.abs(points[:, 1]) <= 1)
                | (np.abs(points[:, 2]) <= 1) | (np.abs(points[:, 3]) <= 1))
        points = points[keep]
    points[:, 2:4] = points[:, 2:4] - points[:, 0:2]
    return img, resample_points_with_constraint(points, max_points, rng)


def _collate(items, max_points: int) -> dict:
    """(img, label, points) samples -> a batch with (P, 6) points zero-padded
    and their (P,) validity."""
    n = len(items)
    points = np.zeros((n, max_points, 6), np.float32)
    pmask = np.zeros((n, max_points), np.float32)
    for i, (_, _, pts) in enumerate(items):
        k = min(len(pts), max_points)
        points[i, :k] = pts[:k]
        pmask[i, :k] = 1.0
    return {"imgs": np.stack([it[0] for it in items]),
            "labels": np.asarray([it[1] for it in items], np.int64),
            "points": points, "pmask": pmask}


class BCPDataset:
    """The reference's `<class>/{layers,masks,annotations}` tree: the label is
    the class folder's number - 1, the input stacks [mask, bmask, emask]
    from the mask and the layer image."""

    def __init__(self, data_path: str, img_size: int, max_points: int = 2048):
        self.max_points, self.img_size = max_points, img_size
        self.items = []
        for cls_name in sorted(os.listdir(data_path)):
            cls_folder = os.path.join(data_path, cls_name)
            layer_path = os.path.join(cls_folder, "layers")
            if not os.path.isdir(layer_path):
                continue
            for name in sorted(os.listdir(layer_path)):
                name = name.split(".")[0]
                with open(os.path.join(cls_folder, "annotations", f"{name}.txt")) as fp:
                    anno = json.load(fp)
                self.items.append({
                    "label": int(cls_name) - 1,
                    "layer": os.path.join(layer_path, f"{name}.png"),
                    "mask": os.path.join(cls_folder, "masks", f"{name}.png"),
                    "points": np.asarray(anno["points"], np.float32)})

    def __len__(self):
        return len(self.items)

    def load(self, idx: int, rng: np.random.Generator):
        it = self.items[idx]
        mask = np.asarray(Image.open(it["mask"]).convert("L"), np.float32) / 255.0
        bmask, emask = decode_layer_mask(np.asarray(Image.open(it["layer"]).convert("RGB")))
        img, pts = augment_points_sample(np.stack([mask, bmask, emask], axis=-1), it["points"],
                                         self.max_points, rng)
        return img, it["label"], pts

    def epoch_batches(self, batch_size: int, seed: int = 0, workers: int = 0) -> Iterator[dict]:
        """Full batches in a seeded order. workers > 0 loads on threads, each
        sample drawing from its own (seed, index) generator, so a batch does
        not depend on the thread order; workers 0 draws every sample from
        one generator in turn."""
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self))
        if workers > 0:
            load = lambda j: self.load(j, np.random.default_rng((seed, int(j))))
            batches = batched_loads(load, order, batch_size, workers)
        else:
            batches = batched_loads(lambda j: self.load(j, rng), order, batch_size)
        for items in batches:
            yield _collate(items, self.max_points)


class BCPDatasetTEST:
    """The test split (dataset.py:641-688): every class-2 and class-3 image,
    its `_mask2` bubble image and `_layer` masks stacked as [img, bmask,
    emask] at img_size (nearest resize)."""

    def __init__(self, data_path: str, img_size: int):
        self.img_size = img_size
        self.items = []
        for cls_name in sorted(os.listdir(data_path)):
            if cls_name not in ("2", "3"):
                continue
            cls_folder = os.path.join(data_path, cls_name)
            for patch in sorted(os.listdir(cls_folder)):
                if any(t in patch for t in ("layer", "mask", "edge", "bubble")):
                    continue
                name, ext = patch.split(".")[:2]
                self.items.append({"img": os.path.join(cls_folder, f"{name}_mask2.{ext}"),
                                   "mask": os.path.join(cls_folder, f"{name}_layer.{ext}")})

    def __len__(self):
        return len(self.items)

    def load(self, idx: int) -> np.ndarray:
        it, s = self.items[idx], self.img_size
        img = np.asarray(Image.open(it["img"]).convert("L").resize((s, s), Image.NEAREST),
                         np.float32) / 255.0
        mask = Image.open(it["mask"]).convert("RGB").resize((s, s), Image.NEAREST)
        bmask, emask = decode_layer_mask(np.asarray(mask))
        return np.stack([img, bmask, emask], axis=-1)


@dataclass
class SyntheticBCPDataset:
    """Synthetic emit bubbles (data/bp_data.py) with per-contour-point
    annotations: up to max_points of the 720 ring samples, their emit lines
    as offsets, the triggers as frequencies, every 16th point a key point."""

    img_size: int = 128
    data_size: int = 512
    max_points: int = 512
    seed: int = 0

    def sample_batch(self, batch_size: int, batch_seed: int = 0) -> dict:
        rng = np.random.default_rng((self.seed, batch_seed))
        imgs, _, p2s = SyntheticEmitDataset(self.img_size, seed=self.seed).sample_batch(
            batch_size, batch_seed)
        p = self.max_points
        points = np.zeros((batch_size, p, 6), np.float32)
        pmask = np.zeros((batch_size, p), np.float32)
        labels = rng.integers(0, 2, size=batch_size).astype(np.int64)
        for b in range(batch_size):
            rows = p2s[b]  # (720, 6): [trig, x, y, dx, dy, len]
            r = rows[np.linspace(0, len(rows) - 1, min(p, len(rows))).astype(int)]
            n = len(r)
            points[b, :n, 0:2] = r[:, 1:3]
            points[b, :n, 2:4] = r[:, 3:5] * r[:, 5:6]
            points[b, :n, 4] = r[:, 0]
            points[b, :n, 5] = np.arange(n) % 16 == 0
            pmask[b, :n] = 1.0
        return {"imgs": imgs, "labels": labels, "points": points, "pmask": pmask}

    def epoch_batches(self, batch_size: int, seed: int = 0, workers: int = 0) -> Iterator[dict]:
        """One epoch of seeded batches; `workers` is taken as BCPDataset takes
        it and ignored (a batch is made in one call)."""
        for i in range(self.data_size // batch_size):
            yield self.sample_batch(batch_size, batch_seed=seed * 10_000 + i)
