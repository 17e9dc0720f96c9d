"""Manga-page bubble segmentation, host side -- the port's own copy of
vaeplay_tpu/eval/manga.py (rebuild of the reference test_BE_manga.py, the
serve path): numpy, PIL and scipy.ndimage only.

  page -> per-bubble square crops (connected components of a coarse mask,
  or labelme boxes), kept uint8 -> batched BE / BE_GAN inference on the
  device (eval/predictor.py) -> the thresholded masks pasted back at page
  coordinates with occupancy dedupe and NoFrame dilation -> a content /
  class / edge PNG (file RGB; the same bytes as the JAX module writes for
  the same page and predictions).

  load_manga_from_mask       test_BE_manga.py:227-291
  load_manga_from_annotation test_BE_manga.py:293-371
  paste_result_on_manga      test_BE_manga.py:63-158
  paste_edge_result_on_manga test_BE_manga.py:160-225
"""

import json
import os
from typing import Dict, List

import numpy as np
from PIL import Image
from scipy.ndimage import label as scipy_label

from vaeplay_torch.utils.viz import makedirs

# test_BE_manga.py:18-23
BUBBLE_TYPES = {"Oval": 1, "Explosion": 2, "NoFrame": 3, "Box": 4}


def _square_crops(img: np.ndarray, boxes: List[List[int]], bimage_size: int):
    """Square-pad each box crop with white and resize to bimage_size
    (test_BE_manga.py:255-280).

    Crops stay uint8: the /255 normalization happens on the device
    (eval/predictor.py, the same f32 values), so the serve path uploads 4x
    fewer bytes."""
    crops, recon = [], []
    for xmin, ymin, xmax, ymax in boxes:
        width, height = xmax - xmin, ymax - ymin
        crop_size = max(width, height)
        crop = img[ymin:ymax, xmin:xmax]
        ax = ay = 0
        if width != height:
            tmp = np.full((crop_size, crop_size, 3), 255, np.uint8)
            if width > height:
                ay = (width - height) // 2
            else:
                ax = (height - width) // 2
            tmp[ay:ay + height, ax:ax + width] = crop
            crop = tmp
        crop = np.asarray(
            Image.fromarray(crop).resize((bimage_size, bimage_size)))
        crops.append(crop)
        recon.append([ax, ay, crop_size])
    return crops, recon


def load_manga_from_mask(img_path: str, mask_path: str, bimage_size: int):
    """Connected components of a coarse bubble mask → crops
    (test_BE_manga.py:227-291)."""
    img = np.asarray(Image.open(img_path).convert("RGB"))
    mask_rgb = np.asarray(Image.open(mask_path).convert("RGB")).copy()
    white = (mask_rgb[:, :, 0] == 255) & (mask_rgb[:, :, 1] == 255) & (mask_rgb[:, :, 2] == 255)
    mask_rgb[white] = 0
    label_mask = mask_rgb[:, :, 1]
    bubble_mask = mask_rgb[:, :, 0]
    h, w = bubble_mask.shape
    labeled, n = scipy_label(bubble_mask)
    boxes, masks, labels = [], [], []
    for i in range(n):
        m = (labeled == (i + 1)).astype(np.uint8)
        pos = np.where(m)
        boxes.append([
            max(int(pos[1].min()) - 200, 0), max(int(pos[0].min()) - 200, 0),
            min(int(pos[1].max()) + 200, w - 1), min(int(pos[0].max()) + 200, h - 1),
        ])
        masks.append(m)
        labels.append(int(label_mask[pos][0]))
    crops, recon = _square_crops(img, boxes, bimage_size)
    return {
        "images": np.stack(crops) if crops else np.zeros((0, bimage_size, bimage_size, 3), np.uint8),
        "recon_info": np.asarray(recon, np.int64).reshape(-1, 3),
        "masks": masks,
        "labels": np.asarray(labels, np.int64),
        "boxes": np.asarray(boxes, np.int64).reshape(-1, 4),
        "original_boxes": None,
    }


def load_manga_from_annotation(img_path: str, anno_path: str, bimage_size: int):
    """labelme Bubble-Boundary boxes (+50px context) → crops
    (test_BE_manga.py:293-371)."""
    img = np.asarray(Image.open(img_path).convert("RGB"))
    with open(anno_path, "r", encoding="utf-8") as f:
        annotation = json.load(f)
    width, height = annotation["imageWidth"], annotation["imageHeight"]
    offset = 50
    boxes, orig_boxes, labels = [], [], []
    for shape in annotation["shapes"]:
        if shape["label"] != "Bubble-Boundary":
            continue
        pts = shape["points"]
        boxes.append([
            int(max(min(pts[0][0], pts[1][0]) - offset, 0)),
            int(max(min(pts[0][1], pts[1][1]) - offset, 0)),
            int(min(max(pts[0][0], pts[1][0]) + offset, width)),
            int(min(max(pts[0][1], pts[1][1]) + offset, height)),
        ])
        orig_boxes.append([
            int(max(min(pts[0][0], pts[1][0]), 0)),
            int(max(min(pts[0][1], pts[1][1]), 0)),
            int(min(max(pts[0][0], pts[1][0]), width)),
            int(min(max(pts[0][1], pts[1][1]), height)),
        ])
        sub = shape.get("sub_label")
        labels.append(BUBBLE_TYPES.get(sub, -1))
    crops, recon = _square_crops(img, boxes, bimage_size)
    return {
        "images": np.stack(crops) if crops else np.zeros((0, bimage_size, bimage_size, 3), np.uint8),
        "recon_info": np.asarray(recon, np.int64).reshape(-1, 3),
        "masks": [np.zeros((0,))] * len(boxes),
        "labels": np.asarray(labels, np.int64),
        "boxes": np.asarray(boxes, np.int64).reshape(-1, 4),
        "original_boxes": np.asarray(orig_boxes, np.int64).reshape(-1, 4),
    }


def _dilate(mask: np.ndarray, kernel_size: int = 13) -> np.ndarray:
    """Binary box dilation = clamp(conv with ones kernel) (test_BE_manga.py:84-88)."""
    from scipy.ndimage import maximum_filter

    return maximum_filter(mask.astype(np.float32), size=kernel_size)


def _resize_nearest(m: np.ndarray, size: int) -> np.ndarray:
    return np.asarray(
        Image.fromarray((m[..., 0] if m.ndim == 3 else m)).resize(
            (size, size), Image.NEAREST))


def paste_result_on_manga(
    img_path: str,
    page: Dict,
    pred_masks: np.ndarray,  # (B, S, S, 1) sigmoid probs
    pred_edges: np.ndarray,
    result_path: str,
    result_name: str,
    kernel_size: int = 13,
) -> np.ndarray:
    """Paste per-bubble predictions back at page coordinates with occupancy
    dedupe; NoFrame bubbles (label 3) use the dilated coarse/box mask instead
    of the prediction (test_BE_manga.py:63-158).  The reference stacks
    [edge, class, content] and writes through cv2 (BGR), so the file on disk
    has content in RED and edge in BLUE — we stack [content, class, edge] and
    save through PIL (RGB) to produce the pixel-identical file, which is what
    load_manga_from_mask's red-channel read expects.  Returns the file-RGB
    array.

    All per-bubble work is confined to the bubble's box region (the merge
    planes are zero everywhere else, so the restriction is exact); the page
    image is never decoded — only its header is read for the dimensions.
    Both cut the host paste cost."""
    with Image.open(img_path) as im:
        w, h = im.size  # header-only; reference reads the array just for h, w
    pred_masks = (pred_masks[..., 0] >= 0.5).astype(np.float32)
    pred_edges = (pred_edges[..., 0] >= 0.5).astype(np.float32)
    result = np.zeros((h, w, 3), np.uint8)
    check = np.zeros((h, w), bool)
    boxes = page["boxes"]
    labels = page["labels"]
    recon = page["recon_info"]
    orig_boxes = page.get("original_boxes")
    for i in range(len(boxes)):
        ax, ay, size = (int(v) for v in recon[i])
        xmin, ymin, xmax, ymax = (int(v) for v in boxes[i])
        bw, bh = xmax - xmin, ymax - ymin
        if labels[i] != 3:
            e_box = _resize_nearest(pred_edges[i], size)[ay:ay + bh, ax:ax + bw]
            b_box = _resize_nearest(pred_masks[i], size)[ay:ay + bh, ax:ax + bw]
        elif orig_boxes is None:
            tmp = page["masks"][i][ymin:ymax, xmin:xmax].astype(np.float32)
            dil = np.clip(_dilate(tmp, kernel_size), 0, 1)
            e_box = dil - tmp
            b_box = tmp
        else:
            oxmin, oymin, oxmax, oymax = (int(v) for v in orig_boxes[i])
            oxmin, oymin = ax + oxmin - xmin, ay + oymin - ymin
            oxmax, oymax = ax + oxmax - xmin, ay + oymax - ymin
            tmp = np.zeros((size, size), np.float32)
            tmp[oymin:oymax, oxmin:oxmax] = 1.0
            dil = np.clip(_dilate(tmp, kernel_size), 0, 1)
            e_box = (dil - tmp)[ay:ay + bh, ax:ax + bw]
            b_box = tmp[ay:ay + bh, ax:ax + bw]
        me = e_box.astype(bool)
        mb = b_box.astype(bool)
        ck = check[ymin:ymax, xmin:xmax]
        me = me & ~mb          # content wins over edge
        me = me & ~ck          # occupancy dedupe
        mb = mb & ~ck
        total = me | mb
        check[ymin:ymax, xmin:xmax] |= total
        result[ymin:ymax, xmin:xmax] += np.stack([
            mb.astype(np.uint8) * 255,
            total.astype(np.uint8) * int(labels[i]),
            me.astype(np.uint8) * 255,
        ], axis=-1)
    result[~check] = 255
    makedirs(result_path)
    Image.fromarray(result).save(os.path.join(result_path, f"{result_name}.png"),
                                 compress_level=1)
    return result


def paste_edge_result_on_manga(
    img_path: str,
    page: Dict,
    pred_edges: np.ndarray,  # (B, S, S, 1) sigmoid probs
    result_path: str,
    result_name: str,
    kernel_size: int = 13,
) -> np.ndarray:
    """Mask-route paste variant (test_BE_manga.py:160-225, used by main_mask
    :373-412): the EDGE comes from the prediction but the CONTENT region is
    the provided coarse connected-component mask (full-page coordinates);
    NoFrame bubbles (label 3) use the dilated coarse mask for both.  Same
    occupancy dedupe and on-disk channel contract (file-RGB = content, class,
    edge — see paste_result_on_manga).  Per-bubble work is box-restricted
    exactly as in paste_result_on_manga."""
    with Image.open(img_path) as im:
        w, h = im.size
    pred_edges = (pred_edges[..., 0] >= 0.5).astype(np.float32)
    result = np.zeros((h, w, 3), np.uint8)
    check = np.zeros((h, w), bool)
    boxes, labels, recon = page["boxes"], page["labels"], page["recon_info"]
    for i in range(len(boxes)):
        ax, ay, size = (int(v) for v in recon[i])
        xmin, ymin, xmax, ymax = (int(v) for v in boxes[i])
        bw, bh = xmax - xmin, ymax - ymin
        comp = page["masks"][i][ymin:ymax, xmin:xmax].astype(np.float32)
        if labels[i] != 3:
            e_box = _resize_nearest(pred_edges[i], size)[ay:ay + bh, ax:ax + bw]
            b_box = comp
        else:
            dil = np.clip(_dilate(comp, kernel_size), 0, 1)
            e_box = dil - comp
            b_box = comp
        me = e_box.astype(bool)
        mb = b_box.astype(bool)
        ck = check[ymin:ymax, xmin:xmax]
        me = me & ~mb
        me = me & ~ck
        mb = mb & ~ck
        total = me | mb
        check[ymin:ymax, xmin:xmax] |= total
        result[ymin:ymax, xmin:xmax] += np.stack([
            mb.astype(np.uint8) * 255,
            total.astype(np.uint8) * int(labels[i]),
            me.astype(np.uint8) * 255,
        ], axis=-1)
    result[~check] = 255
    makedirs(result_path)
    Image.fromarray(result).save(os.path.join(result_path, f"{result_name}.png"),
                                 compress_level=1)
    return result
