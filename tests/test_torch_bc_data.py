"""The port's BC data (vaeplay_torch.data.bc_data) against the JAX package's
(vaeplay_tpu.data.bc_data): the host-traced contour and key-contour
targets, the synthetic batches for a seed, and the folder loader."""

import numpy as np
import pytest
from PIL import Image

from vaeplay_torch.data import bc_data as T
from vaeplay_tpu.data import bc_data as J

KEYS = ("imgs", "bimgs", "eimgs", "tgt_pts", "tgt_mask", "key_pts", "key_mask")


def _ellipses(seed, h, w, n=2):
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    m = np.zeros((h, w), np.float32)
    for _ in range(n):
        cx, cy = rng.uniform(0.25, 0.75, 2) * (w, h)
        rx, ry = rng.uniform(0.08, 0.3, 2) * (w, h)
        m = np.maximum(m, (((xs - cx) / rx) ** 2 + ((ys - cy) / ry) ** 2 <= 1.0))
    return m


@pytest.mark.parametrize("seed,padding,max_points,max_key",
                         [(0, 1, 256, 64), (1, 1, 16, 64), (2, 3, 64, 4), (3, 1, 32, 64)])
def test_contour_targets_match_jax(seed, padding, max_points, max_key):
    """Full contour (decimated) and RDP key contour, padded, with counts."""
    mask = _ellipses(seed, 70, 90)
    got = T.contour_targets_from_mask(mask, padding, max_points, max_key)
    want = J.contour_targets_from_mask(mask, padding, max_points, max_key)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert got[1] > 0 and got[3] > 0


def test_empty_mask_gives_no_targets():
    pts, n, kpts, k = T.contour_targets_from_mask(np.zeros((20, 20), np.float32), 1, 16)
    assert n == k == 0 and not pts.any() and not kpts.any()


@pytest.mark.parametrize("img,batch_seed", [(64, 0), (128, 3)])
def test_synthetic_batches_match_jax(img, batch_seed):
    """SyntheticBCDataset's batches for a seed equal the JAX package's,
    images, masks and targets bit for bit."""
    got = T.SyntheticBCDataset(img_size=img, max_points=32, data_size=8).sample_batch(3, batch_seed)
    want = J.SyntheticBCDataset(img_size=img, max_points=32, data_size=8).sample_batch(3, batch_seed)
    for k in KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["tgt_mask"].sum() > 0 and got["key_mask"].sum() <= got["tgt_mask"].sum()
    epoch = list(T.SyntheticBCDataset(img_size=img, max_points=32, data_size=8).epoch_batches(
        4, seed=1, workers=3))
    assert len(epoch) == 2
    np.testing.assert_array_equal(epoch[1]["tgt_pts"], T.SyntheticBCDataset(
        img_size=img, max_points=32, data_size=8).sample_batch(4, 10_001)["tgt_pts"])


def _write_tree(root, n=5, size=(40, 30)):
    """Class dirs of `<name>.png` with its _edge, _mask and _mask_edge files
    (masks red on white, the reference's layer encoding)."""
    w, h = size
    for i in range(n):
        d = root / ("1" if i % 2 else "2")
        d.mkdir(exist_ok=True)
        rng = np.random.default_rng(i)
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(d / f"p{i}.png")
        Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)).save(d / f"p{i}_edge.png")
        for suffix, ring in (("_mask", False), ("_mask_edge", True)):
            m = _ellipses(10 + i, h, w, 1)
            if ring:
                m = m - np.pad(m, 1)[2:, 1:-1] * np.pad(m, 1)[:-2, 1:-1]
            rgb = np.full((h, w, 3), 255, np.uint8)
            rgb[m > 0] = (255, 0, 0)
            Image.fromarray(rgb).save(d / f"p{i}{suffix}.png")
    (root / "notes.txt").write_text("not a class dir")


@pytest.mark.parametrize("workers", [0, 2])
def test_bc_dataset_matches_jax(tmp_path, workers):
    """The folder scan, each sample's decode and targets, and an epoch's
    batches in the seeded order equal the JAX loader's; debug=N truncates."""
    _write_tree(tmp_path)
    got = T.BCDataset(str(tmp_path), (32, 24), max_points=32)
    want = J.BCDataset(str(tmp_path), (32, 24), max_points=32)
    assert got.imgs == want.imgs and got.bimgs == want.bimgs and got.eimgs == want.eimgs
    assert len(got) == 5
    for a, b in zip(got.load(3), want.load(3)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    g = list(got.epoch_batches(2, seed=4, workers=workers))
    w = list(want.epoch_batches(2, seed=4, workers=workers))
    assert len(g) == len(w) == 2
    for gb, wb in zip(g, w):
        for k in KEYS:
            np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)
    assert len(T.BCDataset(str(tmp_path), (32, 24), debug=2)) == len(
        J.BCDataset(str(tmp_path), (32, 24), debug=2)) == 2
