"""Point, contour and ray visualizers for test_bp and test_bc -- the port's
own copy of the parts of vaeplay_tpu/eval/viz_points.py that BP and BC use
(replaces the reference's cv2 renderers of test_BP.py:100-213 and
test_BC.py:35-85 with PIL drawing)."""

from typing import Optional

import numpy as np
from PIL import Image, ImageDraw

from vaeplay_torch.utils.viz import to_uint8


def draw_points(
    img: np.ndarray,          # (H, W, 3) float [0,1]
    pts: np.ndarray,          # (N, 2) pixel [x, y]
    color=(255, 0, 0), radius: int = 1, valid: Optional[np.ndarray] = None,
) -> np.ndarray:
    pil = Image.fromarray(to_uint8(img))
    draw = ImageDraw.Draw(pil)
    for i, (x, y) in enumerate(np.asarray(pts)):
        if valid is not None and not valid[i]:
            continue
        draw.ellipse([x - radius, y - radius, x + radius, y + radius], fill=color)
    return np.asarray(pil, np.float32) / 255.0


def draw_closed_contour(img: np.ndarray, pts: np.ndarray, color=(255, 255, 255),
                        valid: Optional[np.ndarray] = None) -> np.ndarray:
    """A polyline through the (valid) points, closed back to the first
    (train_BE_GAN.py:44-49)."""
    pil = Image.fromarray(to_uint8(img))
    draw = ImageDraw.Draw(pil)
    pts = np.asarray(pts)
    if valid is not None:
        pts = pts[np.asarray(valid, bool)]
    n = len(pts)
    for j in range(n):
        x0, y0 = pts[j]
        x1, y1 = pts[(j + 1) % n]
        draw.line([float(x0), float(y0), float(x1), float(y1)], fill=color, width=1)
    return np.asarray(pil, np.float32) / 255.0


def draw_rays(
    img: np.ndarray,
    starts: np.ndarray,       # (N, 2) pixel coords
    directions: np.ndarray,   # (N, 2) unit vectors
    lengths: np.ndarray,      # (N,)
    triggers: np.ndarray,     # (N,) bool
    color=(0, 200, 0),
) -> np.ndarray:
    """Emit-line rasterizer: rays from ellipse samples along the predicted
    normals, where the trigger fires (test_BP.py:100-213)."""
    pil = Image.fromarray(to_uint8(img))
    draw = ImageDraw.Draw(pil)
    for i in range(len(starts)):
        if not triggers[i]:
            continue
        x0, y0 = starts[i]
        x1 = x0 + directions[i][0] * lengths[i]
        y1 = y0 + directions[i][1] * lengths[i]
        draw.line([float(x0), float(y0), float(x1), float(y1)], fill=color, width=1)
    return np.asarray(pil, np.float32) / 255.0
