"""The port's BCP data (vaeplay_torch.data.bcp_data) against the JAX package's
(vaeplay_tpu.data.bcp_data): the synthetic batches for a seed, the joint
image-and-point augmentation for one generator state and its pieces, and
both folder loaders over a tiny tree."""

import json

import numpy as np
import pytest
from PIL import Image

from vaeplay_torch.data import bcp_data as T
from vaeplay_tpu.data import bcp_data as J

KEYS = ("imgs", "labels", "points", "pmask")


def _equal(got: dict, want: dict):
    for k in KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("img,max_points,batch_seed", [(64, 64, 0), (128, 1024, 3)])
def test_synthetic_batches_match_jax(img, max_points, batch_seed):
    """SyntheticBCPDataset's batches for a seed equal the JAX package's bit
    for bit (1024 points keeps all 720 ring samples); an epoch is the
    seeded batches in turn, `workers` ignored."""
    got = T.SyntheticBCPDataset(img_size=img, max_points=max_points).sample_batch(3, batch_seed)
    _equal(got, J.SyntheticBCPDataset(img_size=img, max_points=max_points).sample_batch(
        3, batch_seed))
    assert got["pmask"].sum() == 3 * min(max_points, 720)
    assert 0 < got["points"][..., 4].sum() and got["points"][..., 5].sum() > 0
    epoch = list(T.SyntheticBCPDataset(img_size=img, max_points=max_points, data_size=8)
                 .epoch_batches(4, seed=1, workers=3))
    assert len(epoch) == 2
    _equal(epoch[1], J.SyntheticBCPDataset(img_size=img, max_points=max_points)
           .sample_batch(4, 10_001))


def _sample(seed, h=72, w=72, n=300):
    """A blob image [mask, bmask, emask] and n annotation rows [sx, sy, ex,
    ey, freq, key] in pixels, some keys."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    cx, cy, rx, ry = rng.uniform(28, 44), rng.uniform(28, 44), rng.uniform(8, 20), rng.uniform(8, 20)
    blob = (((xs - cx) / rx) ** 2 + ((ys - cy) / ry) ** 2 <= 1.0).astype(np.float32)
    img = np.stack([blob, blob, rng.uniform(size=(h, w)).astype(np.float32)], axis=-1)
    t = rng.uniform(0, 2 * np.pi, n)
    pts = np.zeros((n, 6), np.float32)
    pts[:, 0], pts[:, 1] = cx + rx * np.cos(t), cy + ry * np.sin(t)
    pts[:, 2], pts[:, 3] = pts[:, 0] + 6 * np.cos(t), pts[:, 1] + 6 * np.sin(t)
    pts[:, 4] = rng.uniform(size=n) < 0.3
    pts[:, 5] = rng.uniform(size=n) < 0.1
    return img, pts


@pytest.mark.parametrize("seed,rotate,max_points", [(0, True, 128), (1, True, 4096),
                                                    (2, False, 64), (3, True, 40)])
def test_augment_points_sample_matches_jax(seed, rotate, max_points):
    """The joint affine, flips, out-of-frame filter, offsets and
    key-preserving decimation of one sample, from the same generator state:
    image and points equal, and the generator left in the same state."""
    img, pts = _sample(seed)
    rng_t, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
    got = T.augment_points_sample(img.copy(), pts.copy(), max_points, rng_t, rotate)
    want = J.augment_points_sample(img.copy(), pts.copy(), max_points, rng_j, rotate)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert rng_t.random() == rng_j.random()
    assert len(got[1]) <= max_points


def test_augmentation_pieces_match_jax():
    """resample_points_with_constraint keeps every key point; mask_bbox,
    random_offset and affine_nearest_np equal the JAX package's."""
    img, pts = _sample(4, n=500)
    for cap in (600, 100, 10):
        got = T.resample_points_with_constraint(pts, cap, np.random.default_rng(cap))
        want = J.resample_points_with_constraint(pts, cap, np.random.default_rng(cap))
        np.testing.assert_array_equal(got, want)
        assert (got[:, 5] >= 0.9).sum() == (pts[:, 5] >= 0.9).sum()
    bbox = T.mask_bbox(img[..., 0] > 0)
    assert bbox == J.mask_bbox(img[..., 0] > 0) and T.mask_bbox(np.zeros((4, 4))) is None
    for s in range(4):
        assert (T.random_offset(bbox, 72, np.random.default_rng(s))
                == J.random_offset(bbox, 72, np.random.default_rng(s)))
    np.testing.assert_array_equal(T.affine_nearest_np(img, 0.2, 5.0, -3.0),
                                  J.affine_nearest_np(img, 0.2, 5.0, -3.0))


def _write_train_tree(root, size=48):
    """Class dirs "1" and "2" with layers/masks/annotations triples (layers
    red content on white, annotation points in pixels); a stray file."""
    for i in range(5):
        d = root / ("1" if i % 2 else "2")
        for sub in ("layers", "masks", "annotations"):
            (d / sub).mkdir(parents=True, exist_ok=True)
        img, pts = _sample(20 + i, size, size, n=30 + 7 * i)
        layer = np.full((size, size, 3), 255, np.uint8)
        layer[img[..., 0] > 0] = (255, 0, 0)
        layer[::7, ::5] = (0, 200, 0)
        Image.fromarray(layer).save(d / "layers" / f"s{i}.png")
        Image.fromarray((img[..., 2] * 255).astype(np.uint8)).save(d / "masks" / f"s{i}.png")
        (d / "annotations" / f"s{i}.txt").write_text(json.dumps({"points": pts.tolist()}))
    (root / "notes.txt").write_text("not a class dir")


@pytest.mark.parametrize("workers", [0, 2])
def test_bcp_dataset_matches_jax(tmp_path, workers):
    """BCPDataset over the tree: the same items and labels, and an epoch of
    batches (decode, joint augmentation, padding) equal to the JAX loader's,
    single-stream and with per-sample generators on threads."""
    _write_train_tree(tmp_path)
    got_ds, want_ds = T.BCPDataset(str(tmp_path), 48, 32), J.BCPDataset(str(tmp_path), 48, 32)
    assert len(got_ds) == len(want_ds) == 5
    assert [it["label"] for it in got_ds.items] == [it["label"] for it in want_ds.items]
    got = list(got_ds.epoch_batches(2, seed=3, workers=workers))
    want = list(want_ds.epoch_batches(2, seed=3, workers=workers))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _equal(g, w)
    assert got[0]["imgs"].shape == (2, 48, 48, 3) and got[0]["pmask"].sum() > 0


def test_bcp_dataset_test_matches_jax(tmp_path):
    """BCPDatasetTEST: only classes 2 and 3, each image's `_mask2` and
    `_layer` files resized (nearest) and stacked, equal to the JAX
    loader's."""
    rng = np.random.default_rng(0)
    for cls in ("1", "2", "3"):
        d = tmp_path / cls
        d.mkdir()
        for i in range(2):
            Image.fromarray(rng.integers(0, 255, (40, 30, 3), np.uint8)).save(d / f"p{i}.png")
            Image.fromarray(rng.integers(0, 255, (40, 30), np.uint8)).save(d / f"p{i}_mask2.png")
            layer = np.full((40, 30, 3), 255, np.uint8)
            layer[5:30, 4:25] = (255, 0, 0)
            layer[5:30:3, 4:25] = (0, 255, 0)
            Image.fromarray(layer).save(d / f"p{i}_layer.png")
    got, want = T.BCPDatasetTEST(str(tmp_path), 32), J.BCPDatasetTEST(str(tmp_path), 32)
    assert len(got) == len(want) == 4
    for i in range(4):
        a, b = got.load(i), want.load(i)
        assert a.shape == (32, 32, 3) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
