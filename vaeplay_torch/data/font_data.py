"""Font/kana datasets -- the port's own copy of vaeplay_tpu/data/font_data.py
(rebuild of reference datasets/dataset_font.py), numpy and PIL only, with
the same PIL calls and the same `np.random.default_rng` draws, so one seed
gives the same batch bit for bit:

  ImageDatasetJson   dataset_font.py:18-77   (manga pages + labelme occupied
                      boxes, binarized)
  KanaImageDataset   dataset_font.py:160-179
  FEDataset          dataset_font.py:343-376 (rendered glyph scan, label =
                      codepoint index + 1)
  AugmentOperator    dataset_font.py:182-338 (scale/rotate/shear/white-edge/
                      invert pipeline producing img/mask/content/edge)
  prepare_synthesis  dataset_font.py:79-143  (IoU-checked placement of the
                      augmented glyph onto a page crop + 5-dim style vector)

`SyntheticGlyphDataset` procedurally draws kana-like stroke glyphs with PIL so
the whole BE_font trainer runs hermetically (the reference expects a
./save_folder of pre-rendered font glyphs and a manga page list). Batches are
NHWC float32 numpy arrays in [0, 1]; the trainer copies them to the device
and permutes them to NCHW there.
"""

import json
import math
import os
from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np
from PIL import Image, ImageChops, ImageDraw, ImageFilter, ImageOps

OPPOSITE_THRES = 0.5
MAX_ALLOWED_IOU = 0.1
MAX_ATTEMPTS_TO_SYNTHESIZE = 20
PAGE_AREA = 8000 * 5000


def to_n_n(img: Image.Image, fill):
    """Square-pad (dataset_font.py:145-158)."""
    w, h = img.size
    if w == h:
        return img
    new_size = max(w, h)
    anchor = (0, (w - h) // 2) if w > h else ((h - w) // 2, 0)
    out = Image.new(img.mode, (new_size, new_size), color=fill)
    out.paste(img, anchor)
    return out


class AugmentOperator:
    """PIL glyph augmentation (dataset_font.py:182-338)."""

    def __init__(self):
        self.initial_ratio = 0.018

    @staticmethod
    def do_scale(img, mask, scale):
        w, h = img.size
        new_size = (max(int(w * scale), 1), max(int(h * scale), 1))
        return (img.resize(new_size, Image.NEAREST),
                mask.resize(new_size, Image.NEAREST))

    @staticmethod
    def do_rotate(img, mask, angle):
        return (img.rotate(angle, resample=Image.NEAREST, expand=True,
                           fillcolor=(255, 255, 255)),
                mask.rotate(angle, resample=Image.NEAREST, expand=True))

    @staticmethod
    def do_shear(img, mask, shear, rng=None):
        r = (rng.random() if rng is not None else np.random.rand())
        w, h = img.size
        if r <= 0.5:
            new_w, new_h = w + abs(int(shear * h)), h
            anchor = ((new_w - w) if shear >= 0 else 0, 0)
            data = (1, shear, 0, 0, 1, 0)
        else:
            new_w, new_h = w, h + abs(int(shear * w))
            anchor = (0, (new_h - h) if shear >= 0 else 0)
            data = (1, 0, 0, shear, 1, 0)
        new_img = Image.new(img.mode, (new_w, new_h), color=(255, 255, 255))
        new_img.paste(img, anchor)
        new_img = new_img.transform((new_w, new_h), Image.AFFINE, data=data,
                                    resample=Image.NEAREST,
                                    fillcolor=(255, 255, 255))
        new_mask = Image.new(mask.mode, (new_w, new_h), color=0)
        new_mask.paste(mask, anchor)
        new_mask = new_mask.transform((new_w, new_h), Image.AFFINE, data=data,
                                      resample=Image.NEAREST, fillcolor=0)
        return new_img, new_mask

    @staticmethod
    def do_white_edge(img, mask, kernel_size):
        if kernel_size <= 0 or kernel_size % 2 == 0:
            return img, mask
        new_img = ImageOps.expand(img, border=kernel_size, fill=(255, 255, 255))
        new_mask = ImageOps.expand(mask, border=kernel_size)
        new_mask = new_mask.filter(ImageFilter.MaxFilter(kernel_size))
        return new_img, new_mask

    @staticmethod
    def do_opposite(img, mask):
        tmp = mask.convert("RGB")
        out = Image.new("RGB", img.size, color=(255, 255, 255))
        out = ImageChops.multiply(out, ImageChops.invert(tmp))
        out = ImageChops.add(out, ImageChops.invert(img))
        return out, mask

    def __call__(self, img, mask, target_area, params, rng=None):
        if "scale" in params:
            img, mask = self.do_scale(img, mask, params["scale"])
        if "angle" in params:
            img, mask = self.do_rotate(img, mask, params["angle"])
        if "shear" in params:
            img, mask = self.do_shear(img, mask, params["shear"], rng)
        img, mask = self.do_white_edge(img, mask, params["kernel_size"])
        content_mask = ImageChops.invert(img.convert("L"))
        edge_mask = ImageChops.subtract(mask, content_mask)
        if params.get("p", 0.0) > OPPOSITE_THRES:
            img, mask = self.do_opposite(img, mask)
            k = params["kernel_size"]
            img = ImageOps.expand(img, border=k, fill=(255, 255, 255))
            mask = ImageOps.expand(mask, border=k)
            mask = mask.filter(ImageFilter.MaxFilter(k)) if k % 2 == 1 and k > 0 else mask
            content_mask = ImageOps.expand(content_mask, border=k)
            edge_mask = ImageOps.expand(edge_mask, border=k)
        w, h = img.size
        scale = math.sqrt(self.initial_ratio * target_area / (w * h))
        new_size = (max(int(w * scale), 2), max(int(h * scale), 2))
        img = img.resize(new_size, Image.NEAREST)
        mask = mask.resize(new_size, Image.NEAREST)
        content_mask = content_mask.resize(new_size, Image.NEAREST)
        edge_mask = edge_mask.resize(new_size, Image.NEAREST)
        true_box = mask.getbbox()
        if true_box is not None:
            img = img.crop(true_box)
            mask = mask.crop(true_box)
            content_mask = content_mask.crop(true_box)
            edge_mask = edge_mask.crop(true_box)
        img = to_n_n(img, (255, 255, 255))
        mask = to_n_n(mask, 0)
        content_mask = to_n_n(content_mask, 0)
        edge_mask = to_n_n(edge_mask, 0)
        return img, mask, content_mask, edge_mask


def prepare_synthesis_data(base_img, target, kana_imgs, kana_masks, augmentor,
                           rng: np.random.Generator):
    """Composite augmented glyphs onto page crops (dataset_font.py:79-143)."""
    iw, ih = base_img.size
    page_area = target["real_page_area"]
    occupied = np.asarray(target["occupied_boxes"], np.float64)
    out_imgs, out_masks, out_edges, out_styles = [], [], [], []
    for kana_img, kana_mask in zip(kana_imgs, kana_masks):
        ks = int(round(rng.uniform(4, 17), 0)) // 2
        params = {
            "scale": rng.uniform(0.707, 1.414),
            "angle": rng.uniform(-15, 15),
            "shear": rng.uniform(-0.8, 0.8),
            "kernel_size": ks + (ks + 1) % 2,
            "p": rng.uniform(0.0, 1.0),
        }
        aug_img, aug_mask, aug_content, aug_edge = augmentor(
            kana_img, kana_mask, page_area, params, rng)
        aw, ah = aug_img.size
        cx, cy = aw // 2, ah // 2
        hi_x = max(iw - cx - 1 - cx, 1)
        hi_y = max(ih - cy - 1 - cy, 1)
        xmin = rng.integers(0, hi_x, MAX_ATTEMPTS_TO_SYNTHESIZE)
        ymin = rng.integers(0, hi_y, MAX_ATTEMPTS_TO_SYNTHESIZE)
        boxes = np.stack([xmin, ymin, xmin + aw, ymin + ah], axis=1)
        if len(occupied):
            area_new = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
            area_ocp = (occupied[:, 2] - occupied[:, 0]) * (occupied[:, 3] - occupied[:, 1])
            lt = np.maximum(boxes[:, None, :2], occupied[:, :2])
            rb = np.minimum(boxes[:, None, 2:], occupied[:, 2:])
            wh = np.clip(rb - lt, 0, None)
            inter = wh[:, :, 0] * wh[:, :, 1]
            union = area_new[:, None] + area_ocp - inter
            iou = inter / np.maximum(union, 1e-9)
            ok = np.sum(iou <= MAX_ALLOWED_IOU, axis=1)
            box = boxes[0] if ok.sum() == 0 else boxes[int(np.argmax(ok))]
        else:
            box = boxes[0]
        crop = base_img.crop(tuple(int(v) for v in box))
        crop.paste(aug_img, mask=aug_mask)
        out_imgs.append(crop)
        out_masks.append(aug_content)
        out_edges.append(aug_edge)
        out_styles.append([
            1 if params["p"] > 0.5 else 0, params["scale"], params["angle"],
            params["shear"], params["kernel_size"],
        ])
    return out_imgs, out_masks, out_edges, out_styles


class ImageDatasetJson:
    """Manga-page base dataset from a training_data.json list with labelme
    occupied boxes (dataset_font.py:18-77)."""

    def __init__(self, image_list: str):
        self.imgs: List[str] = []
        self.targets: List[dict] = []
        with open(image_list, "r") as f:
            data_sets = json.load(f)
        for data in data_sets:
            with open(data["annotation_path"], "r", encoding="utf-8") as f:
                annotation = json.load(f)
            width, height = annotation["imageWidth"], annotation["imageHeight"]
            occupied = []
            for shape in annotation["shapes"]:
                if shape["label"] in ("Bubble", "Onomatopoeia-Kana"):
                    pts = shape["points"]
                    occupied.append([
                        max(min(pts[0][0], pts[1][0]), 0),
                        max(min(pts[0][1], pts[1][1]), 0),
                        min(max(pts[0][0], pts[1][0]), width),
                        min(max(pts[0][1], pts[1][1]), height),
                    ])
            if occupied:
                self.imgs.append(
                    os.path.join(data["manga_folder"], annotation["imagePath"]))
                area = width * height
                if data.get("data_type") == "manga109":
                    area /= 2
                self.targets.append({
                    "occupied_boxes": np.asarray(occupied, np.float64),
                    "real_page_area": area,
                })

    def __len__(self):
        return len(self.imgs)

    def load(self, index: int):
        img = Image.open(self.imgs[index]).convert("L")
        img = img.point(lambda p: 255 if p > 128 else 0)
        return img.convert("RGB"), self.targets[index]


class KanaImageDataset:
    """Folder of kana images, binarized + white-padded + squared
    (dataset_font.py:160-179)."""

    def __init__(self, image_folder: str):
        self.imgs = [os.path.join(image_folder, fp)
                     for fp in sorted(os.listdir(image_folder))]

    def __len__(self):
        return len(self.imgs)

    def load(self, idx: int) -> Image.Image:
        img = Image.open(self.imgs[idx]).convert("L")
        img = img.point(lambda p: 255 if p > 128 else 0)
        img = img.convert("RGB")
        img = ImageOps.expand(img, border=11, fill=(255, 255, 255))
        return to_n_n(img, (255, 255, 255))


class FEDataset:
    """Rendered glyph scan: save_folder/<style>/<codepoint>.png
    (dataset_font.py:343-376)."""

    def __init__(self, fonts_path: str = "./save_folder"):
        self.imgs: List[str] = []
        self.labels: List[int] = []
        for style in sorted(os.listdir(fonts_path)):
            style_path = os.path.join(fonts_path, style)
            for c in sorted(os.listdir(style_path)):
                self.imgs.append(os.path.join(style_path, c))
                self.labels.append(int(c.split(".")[0]) + 1)

    def __len__(self):
        return len(self.imgs)

    def load(self, idx: int):
        img = Image.open(self.imgs[idx]).convert("L")
        img = img.point(lambda p: 255 if p > 128 else 0)
        mask = ImageChops.invert(img)
        return img.convert("RGB"), mask, self.labels[idx]


@dataclass
class SyntheticGlyphDataset:
    """Procedural kana-ish glyphs: random thick strokes/arcs on white; labels
    are stroke-pattern buckets in [0, 143)."""

    data_size: int = 1024
    glyph_size: int = 96
    num_classes: int = 143
    seed: int = 0

    def glyph(self, rng: np.random.Generator) -> Tuple[Image.Image, Image.Image, int]:
        n = self.glyph_size
        img = Image.new("L", (n, n), 255)
        draw = ImageDraw.Draw(img)
        label = int(rng.integers(1, self.num_classes))
        strokes = 2 + label % 4
        for _ in range(strokes):
            kind = rng.integers(0, 3)
            x0, y0, x1, y1 = rng.integers(8, n - 8, 4)
            wdt = int(rng.integers(3, 9))
            if kind == 0:
                draw.line([int(x0), int(y0), int(x1), int(y1)], fill=0, width=wdt)
            elif kind == 1:
                box = [int(min(x0, x1)), int(min(y0, y1)),
                       int(min(x0, x1)) + int(abs(x1 - x0)) + 8,
                       int(min(y0, y1)) + int(abs(y1 - y0)) + 8]
                draw.arc(box, int(rng.integers(0, 180)), int(rng.integers(180, 360)),
                         fill=0, width=wdt)
            else:
                draw.ellipse([int(x0) - 4, int(y0) - 4, int(x0) + 4, int(y0) + 4],
                             fill=0)
        img = img.point(lambda p: 255 if p > 128 else 0)
        mask = ImageChops.invert(img)
        return img.convert("RGB"), mask, label

    def page(self, rng: np.random.Generator, size: int = 512):
        """A fake manga page: white with random dark panels as occupied boxes."""
        img = Image.new("RGB", (size, size), (255, 255, 255))
        draw = ImageDraw.Draw(img)
        boxes = []
        for _ in range(int(rng.integers(1, 4))):
            x0, y0 = rng.integers(0, size // 2, 2)
            w, h = rng.integers(size // 8, size // 3, 2)
            draw.rectangle([int(x0), int(y0), int(x0 + w), int(y0 + h)],
                           outline=0, width=3)
            boxes.append([x0, y0, x0 + w, y0 + h])
        target = {"occupied_boxes": np.asarray(boxes, np.float64),
                  "real_page_area": float(size * size) * 30}
        return img, target

    def batches(self, batch_size: int, img_size: int, seed: int = 0) -> Iterator[dict]:
        augmentor = AugmentOperator()
        for b in range(self.data_size // batch_size):
            rng = np.random.default_rng((self.seed, seed, b))
            base_img, target = self.page(rng)
            kana = [self.glyph(rng) for _ in range(batch_size)]
            imgs, masks, labels = zip(*kana)
            t_imgs, t_masks, t_edges, t_styles = prepare_synthesis_data(
                base_img, target, imgs, masks, augmentor, rng)

            yield synthesis_batch(t_imgs, t_masks, t_edges, labels, t_styles, img_size)


def _to_array(pil: Image.Image, ch: int, img_size: int) -> np.ndarray:
    """A PIL image resized (bilinear) to img_size, as float32 in [0, 1]:
    (S, S, 3) for ch 3, (S, S, 1) for ch 1."""
    pil = pil.resize((img_size, img_size), Image.BILINEAR)
    a = np.asarray(pil, np.float32) / 255.0
    if ch == 3 and a.ndim == 2:
        a = np.stack([a] * 3, -1)
    if ch == 1:
        if a.ndim == 3:
            a = a[..., 0]
        a = a[..., None]
    return a


def synthesis_batch(t_imgs, t_masks, t_edges, labels, t_styles, img_size: int) -> dict:
    """prepare_synthesis_data's output and the glyphs' labels as one NHWC
    batch: imgs (B, S, S, 3), masks and edges (B, S, S, 1), labels (B,)
    int64, styles (B, 5) float32."""
    return {
        "imgs": np.stack([_to_array(x.convert("RGB"), 3, img_size) for x in t_imgs]),
        "masks": np.stack([_to_array(x, 1, img_size) for x in t_masks]),
        "edges": np.stack([_to_array(x, 1, img_size) for x in t_edges]),
        "labels": np.asarray(labels, np.int64),
        "styles": np.asarray(t_styles, np.float32),
    }
