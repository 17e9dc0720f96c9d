"""BE_GAN and Style_GAN data -- the port's own copy of
vaeplay_tpu/data/be_gan_data.py (rebuild of the reference BEGanDataset,
datasets/dataset.py:730-878, BEDatasetGAN :278-329, and the manga-page
walker ImageDataset :699-727).

On the host, per sample, as the reference does: the file scan, decode and
resize, the joint affine / scale / flip augmentation with the contours
transformed alike, the background-synthesis compositing and the gaussian
blur. Contours ship padded to a fixed capacity. Given the same rng, the
batches equal the JAX classes' bit for bit.
"""

import json
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from PIL import Image, ImageFilter

from vaeplay_torch.data.bp_data import decode_layer_mask
from vaeplay_torch.data.prefetch import batched_loads

MAX_CONTOUR_POINTS = 1024


def bbox2(img: np.ndarray) -> Tuple[int, int, int, int]:
    """(rmin, cmin, rmax, cmax) of nonzero pixels (dataset.py:690-697)."""
    rows = np.any(img, axis=1)
    cols = np.any(img, axis=0)
    cmin, cmax = np.where(rows)[0][[0, -1]]
    rmin, rmax = np.where(cols)[0][[0, -1]]
    return rmin, cmin, rmax, cmax


def random_offset(bbox, img_size, rng, maximum=None, offset=None):
    """dataset.py:462-492."""
    left, upper, right, lower = bbox
    right = img_size - right
    lower = img_size - lower
    if offset is not None:
        left, upper = left + offset, upper + offset
        right, lower = right + offset, lower + offset
    if maximum is not None:
        left = min(left, maximum)
        upper = min(upper, maximum)
        right = min(right, maximum)
        lower = min(lower, maximum)
    left = -left + 1
    upper = -upper + 1
    ox = int(rng.integers(left, right)) if left < right else 0
    oy = int(rng.integers(upper, lower)) if upper < lower else 0
    return ox, oy


def _affine_nearest(arr: np.ndarray, angle_deg: float, translate, scale: float,
                    fill: float) -> np.ndarray:
    """torchvision TF.affine equivalent (rotation about center + translate +
    scale, NEAREST) on an (H, W[, C]) array."""
    squeeze = arr.ndim == 2
    if squeeze:
        arr = arr[..., None]
    h, w, c = arr.shape
    theta = -angle_deg * np.pi / 180.0  # inverse map
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    cos_t, sin_t = np.cos(theta), np.sin(theta)
    inv_scale = 1.0 / scale
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    x0 = xs - cx - translate[0]
    y0 = ys - cy - translate[1]
    sx = (cos_t * x0 - sin_t * y0) * inv_scale + cx
    sy = (sin_t * x0 + cos_t * y0) * inv_scale + cy
    xi = np.round(sx).astype(np.int64)
    yi = np.round(sy).astype(np.int64)
    inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    out = np.full((h, w, c), fill, arr.dtype)
    out[inb] = arr[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)][inb]
    return out[..., 0] if squeeze else out


def _pad_contour(cnt: np.ndarray, cap: int = MAX_CONTOUR_POINTS):
    buf = np.zeros((cap, 2), np.float32)
    n = min(len(cnt), cap)
    if n:
        buf[:n] = cnt[:n]
    return buf, n


class BEGanDataset:
    """imgs + masks + JSON contour annotations with affine/flip augmentation
    and optional background compositing (dataset.py:730-878)."""

    def __init__(self, data_path: str, img_size: int, if_test: bool = False):
        self.img_size = img_size
        self.if_test = if_test
        self.items: List[dict] = []
        wanted = ["test"] if if_test else ["1", "2", "3"]
        for cls_name in sorted(os.listdir(data_path)):
            if cls_name not in wanted:
                continue
            cls_folder = os.path.join(data_path, cls_name)
            for patch in sorted(os.listdir(cls_folder)):
                if any(t in patch for t in ("layer", "mask", "edge", "bubble")):
                    continue
                name = patch.split(".")[0]
                item = {"img": os.path.join(cls_folder, f"{name}.png")}
                if not if_test:
                    item["mask"] = os.path.join(cls_folder, f"{name}_layer.png")
                    item["label"] = int(cls_name)
                    with open(os.path.join(cls_folder, f"{name}.json")) as fp:
                        anno = json.load(fp)
                    item["cnt_content"] = np.asarray(anno["points_content"], np.float32)
                    item["cnt_boundary"] = np.asarray(anno["points_boundary"], np.float32)
                self.items.append(item)
        self.synthesis_target: Optional[np.ndarray] = None  # (H, W, 3) page

    def __len__(self):
        return len(self.items)

    def load(self, idx: int, rng: np.random.Generator):
        it = self.items[idx]
        pil = Image.open(it["img"]).convert("RGB")
        width, height = pil.size
        img = np.asarray(pil.resize((self.img_size, self.img_size)),
                         np.float32) / 255.0
        mask = Image.open(it["mask"]).convert("RGB").resize(
            (self.img_size, self.img_size), Image.NEAREST)
        bimg, eimg = decode_layer_mask(np.asarray(mask))
        label = it["label"]
        cc = it["cnt_content"].copy()
        cb = it["cnt_boundary"].copy()

        cx, cy = width * 0.5, height * 0.5
        scaling = rng.uniform(1.0, 1.3)
        rot_deg = rng.uniform(-15, 15)
        rot = rot_deg * np.pi / 180.0
        ox, oy = random_offset(bbox2(bimg), self.img_size, rng, maximum=50)
        if ox != 0 or oy != 0:
            img = _affine_nearest(img, rot_deg, (ox, oy), scaling, 1.0)
            bimg = _affine_nearest(bimg, rot_deg, (ox, oy), scaling, 0.0)
            eimg = _affine_nearest(eimg, rot_deg, (ox, oy), scaling, 0.0)
            for cnt in (cc, cb):
                x0 = cnt[:, 0] - cx
                y0 = cnt[:, 1] - cy
                tx = (x0 * np.cos(rot) - y0 * np.sin(rot)) * scaling
                ty = (x0 * np.sin(rot) + y0 * np.cos(rot)) * scaling
                cnt[:, 0] = tx + cx + ox
                cnt[:, 1] = ty + cy + oy
        cc[:, :2] = (cc[:, :2] / width - 0.5) / 0.5
        cb[:, :2] = (cb[:, :2] / width - 0.5) / 0.5
        if rng.random() < 0.5:
            img, bimg, eimg = img[::-1].copy(), bimg[::-1].copy(), eimg[::-1].copy()
            cc[:, 1] *= -1
            cb[:, 1] *= -1
        if rng.random() < 0.5:
            img = img[:, ::-1].copy()
            bimg = bimg[:, ::-1].copy()
            eimg = eimg[:, ::-1].copy()
            cc[:, 0] *= -1
            cb[:, 0] *= -1
        cc = cc[(np.abs(cc[:, 0]) <= 1) & (np.abs(cc[:, 1]) <= 1)]
        cb = cb[(np.abs(cb[:, 0]) <= 1) & (np.abs(cb[:, 1]) <= 1)]

        if self.synthesis_target is not None:
            page = self.synthesis_target
            h, w = page.shape[:2]
            half = self.img_size // 2
            xmin = int(rng.integers(half, w - half - 1)) - half
            ymin = int(rng.integers(half, h - half - 1)) - half
            crop = page[ymin:ymin + self.img_size, xmin:xmin + self.img_size].copy()
            total = np.logical_or(bimg > 0, eimg > 0)
            crop[total] = img[total]
            img = np.asarray(
                Image.fromarray((crop * 255).astype(np.uint8)).filter(
                    ImageFilter.GaussianBlur(radius=2)),
                np.float32) / 255.0

        return img, bimg[..., None], eimg[..., None], label, cc, cb

    def epoch_batches(self, batch_size: int, seed: int = 0,
                      workers: int = 0) -> Iterator[dict]:
        """workers > 0 pools decode + affine aug on threads with per-sample
        (seed, index) child rngs (deterministic regardless of thread order);
        workers=0 keeps the original single-stream draws."""
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self))
        if workers > 0:
            load = lambda j: self.load(j, np.random.default_rng((seed, int(j))))
            item_batches = batched_loads(load, order, batch_size, workers)
        else:
            stop = (len(self) // batch_size) * batch_size
            seq = (self.load(int(j), rng) for j in order[:stop])
            item_batches = ([next(seq) for _ in range(batch_size)]
                            for _ in range(stop // batch_size))
        for items in item_batches:
            imgs, bimgs, eimgs, labels, ccs, cbs = zip(*items)
            cc_buf = [_pad_contour(c) for c in ccs]
            cb_buf = [_pad_contour(c) for c in cbs]
            yield {
                "imgs": np.stack(imgs), "bimgs": np.stack(bimgs),
                "eimgs": np.stack(eimgs),
                "labels": np.asarray(labels, np.int64),
                "cnt_content": np.stack([b for b, _ in cc_buf]),
                "cnt_content_n": np.asarray([n for _, n in cc_buf], np.int32),
                "cnt_boundary": np.stack([b for b, _ in cb_buf]),
                "cnt_boundary_n": np.asarray([n for _, n in cb_buf], np.int32),
            }


class MangaPageDataset:
    """Manga-page walker for the BE_GAN aug stream (dataset.py:699-727)."""

    TITLES = ("AttackOnTitan", "DragonBall", "InitialD",
              "KurokosBasketball", "OnePiece")

    def __init__(self, manga_root_folder: str, titles=None):
        self.imgs: List[str] = []
        titles = titles or self.TITLES
        for manga in sorted(os.listdir(manga_root_folder)):
            if manga not in titles:
                continue
            m_path = os.path.join(manga_root_folder, manga)
            for epi in sorted(os.listdir(m_path)):
                for chapter in sorted(os.listdir(os.path.join(m_path, epi))):
                    folder = os.path.join(m_path, epi, chapter, "OriginSizeManga")
                    if not os.path.isdir(folder):
                        continue
                    for page in sorted(os.listdir(folder)):
                        self.imgs.append(os.path.join(folder, page))

    def __len__(self):
        return len(self.imgs)

    def load(self, index: int) -> np.ndarray:
        return np.asarray(
            Image.open(self.imgs[index]).convert("RGB"), np.float32) / 255.0


class BEGanStyleDataset:
    """BEDatasetGAN (dataset.py:278-329): `_mask2` bubble images + content
    masks + remapped labels ({1,2}→1, 3→2, then -1), with the BTransform
    joint rotation/flip handled on device by the trainer."""

    def __init__(self, data_path: str, img_size: int, select_list=None):
        self.img_size = img_size
        self.items: List[dict] = []
        for cls_name in sorted(os.listdir(data_path)):
            if select_list is not None and int(cls_name) not in tuple(select_list):
                continue
            try:
                cls_label = int(cls_name)
            except ValueError:
                continue
            cls_label = 1 if cls_label in (1, 2) else 2
            cls_folder = os.path.join(data_path, cls_name)
            for patch in sorted(os.listdir(cls_folder)):
                if any(t in patch for t in ("layer", "mask", "edge", "bubble")):
                    continue
                name, ext = patch.split(".")[:2]
                self.items.append({
                    "img": os.path.join(cls_folder, f"{name}_mask2.{ext}"),
                    "mask": os.path.join(cls_folder, f"{name}_layer.{ext}"),
                    "label": cls_label - 1,
                })

    def __len__(self):
        return len(self.items)

    def load(self, idx: int):
        it = self.items[idx]
        s = self.img_size
        img = np.asarray(
            Image.open(it["img"]).convert("RGB").resize((s, s), Image.NEAREST),
            np.float32) / 255.0
        mask = Image.open(it["mask"]).convert("RGB").resize((s, s), Image.NEAREST)
        bimg, _ = decode_layer_mask(np.asarray(mask))
        return img, bimg[..., None], it["label"]

    def epoch_batches(self, batch_size: int, seed: int = 0, workers: int = 0) -> Iterator[dict]:
        """One epoch in a seeded order, a last partial batch dropped; workers
        > 0 loads on a thread pool, with the same batches."""
        order = np.random.default_rng(seed).permutation(len(self))
        for items in batched_loads(self.load, order, batch_size, workers):
            imgs, bimgs, labels = zip(*items)
            yield {
                "imgs": np.stack(imgs), "bimgs": np.stack(bimgs),
                "labels": np.asarray(labels, np.int64),
            }
