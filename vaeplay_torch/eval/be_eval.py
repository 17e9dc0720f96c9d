"""BE inference grids -- port of vaeplay_tpu/eval/be_eval.py (rebuild of
reference test_BE.py:26-62, save_test_batch)."""

import os
from typing import Dict

import numpy as np
import torch

from vaeplay_torch.utils.viz import save_image_grid


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).float().cpu().numpy()


def save_test_batch(imgs: torch.Tensor, preds: Dict[str, torch.Tensor], res_output: str,
                    name: str, threshold: float = 0.5) -> str:
    """imgs (B, 3, H, W) in [0, 1]; preds the sigmoid "masks" and "edges" (B,
    1, H, W). Writes <res_output>/<name>.png: a row of inputs, a row of masks
    and a row of edges thresholded at `threshold`; returns its path."""
    masks = (_nhwc(preds["masks"]) > threshold).astype(np.float32)
    edges = (_nhwc(preds["edges"]) > threshold).astype(np.float32)
    grid = np.concatenate([_nhwc(imgs), np.repeat(masks, 3, axis=-1),
                           np.repeat(edges, 3, axis=-1)], axis=0)
    path = os.path.join(res_output, f"{name}.png")
    save_image_grid(grid, path, nrow=imgs.shape[0])
    return path
