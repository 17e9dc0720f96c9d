"""Synthetic circle dataset -- the port's own copy of
vaeplay_tpu/data/circles.py (rebuild of the reference CDataset,
datasets/dataset.py:23-93). Pure numpy and PIL.

Only the (B, 3) [radius, cx, cy] parameter triples live on the host; the
circle train step renders the images on the device from them
(ops/geometry.render_circle_batch), so no image crosses the host->device
link. The same seed gives the JAX package's parameter table and batch order.
"""

import os
from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np

from vaeplay_torch.data.prefetch import batched_loads


@dataclass
class CircleDataset:
    """Procedural circles: params ~ the reference's generate_circle_param."""

    n: int = 128
    min_radius: int = 10
    data_size: int = 4096
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        half = self.n // 2
        radius = rng.integers(self.min_radius, half - self.min_radius, size=self.data_size)
        # the high bound of a center depends on its radius: draw wide, then mod
        cx = radius + (rng.integers(0, 1 << 30, size=self.data_size) % (self.n - 2 * radius))
        cy = radius + (rng.integers(0, 1 << 30, size=self.data_size) % (self.n - 2 * radius))
        self.params = np.stack([radius, cx, cy], axis=-1).astype(np.float32)

    def __len__(self) -> int:
        return self.data_size

    def epoch_batches(self, batch_size: int, epoch_seed: int = 0,
                      workers: int = 0) -> Iterator[np.ndarray]:
        """Shuffled (B, 3) [radius, cx, cy] batches, a last partial batch
        dropped. `workers` is taken as DiskCircleDataset takes it and ignored
        (a batch is one fancy index)."""
        order = np.random.default_rng(epoch_seed).permutation(self.data_size)
        stop = (self.data_size // batch_size) * batch_size
        for i in range(0, stop, batch_size):
            yield self.params[order[i:i + batch_size]]


def render_circle_np(n: int, x: float, y: float, radius: float) -> np.ndarray:
    """Host-side circle render matching generate_circle_img
    (tools/utils.py:24-42): white disk on black, (n, n, 1) float in [0, 1]."""
    ys, xs = np.mgrid[0:n, 0:n]
    d = np.sqrt((xs - x) ** 2 + (ys - y) ** 2)
    return (d <= radius).astype(np.float32)[..., None]


def write_circle_dataset(data_dir: str, dataset: CircleDataset) -> int:
    """Write a dataset to disk in the reference's filename-encoded layout
    `{idx}_{radius}_{x}_{y}.png` (CDataset ifWrite, dataset.py:57-58).
    Returns the number of files written."""
    from PIL import Image

    os.makedirs(data_dir, exist_ok=True)
    for i, (r, x, y) in enumerate(dataset.params):
        img = (render_circle_np(dataset.n, x, y, r)[..., 0] * 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(data_dir, f"{i}_{int(r)}_{int(x)}_{int(y)}.png"))
    return len(dataset.params)


class DiskCircleDataset:
    """The reference CDataset's disk mode (ifGen=False, dataset.py:35-48):
    `{idx}_{r}_{x}_{y}.png` files under `data_dir`, params decoded from the
    name, grayscale images downscaled to n when larger (dataset.py:65-67).
    epoch_batches yields ((B, n, n, 1) images, (B, 3) params)."""

    def __init__(self, data_dir: str, n: int):
        self.n = n
        self.files, params = [], []
        for f in sorted(os.listdir(data_dir)):
            try:
                _, r, x, y = f.split(".")[0].split("_")
            except ValueError:
                continue
            self.files.append(os.path.join(data_dir, f))
            params.append((float(r), float(x), float(y)))
        self.params = np.asarray(params, np.float32).reshape(-1, 3)

    def __len__(self) -> int:
        return len(self.files)

    def load(self, idx: int) -> np.ndarray:
        from PIL import Image

        img = Image.open(self.files[idx]).convert("L")
        if img.size[0] > self.n:
            img = img.resize((self.n, self.n))
        return (np.asarray(img, np.float32) / 255.0)[..., None]

    def epoch_batches(self, batch_size: int, epoch_seed: int = 0,
                      workers: int = 0) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """A seeded shuffle in full batches; workers > 0 pools the PNG decode
        on a thread pool (the reference's DataLoader workers)."""
        order = np.random.default_rng(epoch_seed).permutation(len(self))
        for i, items in zip(range(0, len(self), batch_size),
                            batched_loads(self.load, order, batch_size, workers)):
            yield np.stack(items), self.params[order[i:i + batch_size]]


def encode_targets(n: int, params: np.ndarray) -> np.ndarray:
    """(B, 3) raw [radius, cx, cy] -> (B, 3) encoded [log r/n, x, y] targets,
    the collate_fn's encoding (datasets/dataset.py:71-93), in numpy for the
    disk mode's host batches; mirrors ops/geometry.encode_circle_param."""
    params = np.asarray(params, np.float32)
    half = n // 2
    return np.stack([np.log(params[:, 0] / n), (params[:, 1] - half) / half,
                     (params[:, 2] - half) / half], axis=-1).astype(np.float32)
