"""The port's BE_GAN and Style_GAN data (vaeplay_torch.data.be_gan_data)
against the JAX package's data/be_gan_data.py on a temporary folder in the
reference's layout: BEGanDataset's augmented batches and padded contours
(sequential and on loader threads, with and without background
compositing), MangaPageDataset's walk, BEGanStyleDataset's batches, all
equal bit for bit."""

import json
import os
import shutil

import numpy as np
import pytest
from PIL import Image

from vaeplay_torch.data import be_gan_data as T
from vaeplay_tpu.data import be_gan_data as J

S = 64


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """Class folders 1-3 of bubble crops (random pixels, larger than S so
    the resize acts), each with its `_layer` mask, `_mask2` image and JSON
    contours, the same crops without the JSONs for the style dataset, and a
    manga tree of two pages."""
    root = tmp_path_factory.mktemp("began")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:80, 0:80]
    for cls, names in (("1", ["a", "b"]), ("2", ["c"]), ("3", ["d", "e"])):
        os.makedirs(root / "data" / cls)
        for name in names:
            d = root / "data" / cls
            Image.fromarray(rng.integers(0, 256, (80, 80, 3), dtype=np.uint8)).save(d / f"{name}.png")
            Image.fromarray(rng.integers(0, 256, (80, 80, 3), dtype=np.uint8)).save(
                d / f"{name}_mask2.png")
            cx, cy, r = rng.integers(30, 50, 2).tolist() + [int(rng.integers(10, 20))]
            inside = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
            ring = inside & ((xx - cx) ** 2 + (yy - cy) ** 2 >= (r - 3) ** 2)
            layer = np.full((80, 80, 3), 255, np.uint8)
            layer[inside] = (255, 0, 0)
            layer[ring] = (0, 255, 0)
            Image.fromarray(layer).save(d / f"{name}_layer.png")
            t = np.linspace(0, 2 * np.pi, 40, endpoint=False)
            pts = np.stack([cx + r * np.cos(t), cy + r * np.sin(t)], 1)
            with open(d / f"{name}.json", "w") as f:
                json.dump({"points_content": (pts * 0.8).tolist(), "points_boundary": pts.tolist()}, f)
    for cls in ("1", "2", "3"):
        os.makedirs(root / "style" / cls)
        for f in os.listdir(root / "data" / cls):
            if f.endswith(".png"):
                shutil.copy(root / "data" / cls / f, root / "style" / cls / f)
    for title, page in (("OnePiece", "p0"), ("OnePiece", "p1"), ("Other", "p2")):
        d = root / "manga" / title / "ep1" / "ch1" / "OriginSizeManga"
        os.makedirs(d, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (150, 120, 3), dtype=np.uint8)).save(d / f"{page}.png")
    return root


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("workers", [0, 2])
def test_be_gan_dataset_matches_jax(folder, workers):
    """The same epochs (two seeds, batches of 2): images, masks, labels and
    the padded contours with their counts. The scan skips only names with
    "layer", "mask", "edge" or "bubble", so each sample is listed twice, by
    its PNG and by its JSON, as in the JAX class."""
    port, ref = T.BEGanDataset(str(folder / "data"), S), J.BEGanDataset(str(folder / "data"), S)
    assert len(port) == len(ref) == 10
    for seed in (0, 1):
        got = list(port.epoch_batches(2, seed, workers))
        want = list(ref.epoch_batches(2, seed, workers))
        _assert_batches_equal(got, want)
    b = got[0]
    assert b["imgs"].shape == (2, S, S, 3) and b["bimgs"].shape == (2, S, S, 1)
    assert b["cnt_content"].shape == (2, T.MAX_CONTOUR_POINTS, 2)
    assert (b["cnt_content_n"] > 0).all() and set(b["labels"].tolist()) <= {1, 2, 3}


def test_be_gan_dataset_compositing_matches_jax(folder):
    """With a manga page as the synthesis target, the crops are composited
    onto it and blurred, as the JAX class does."""
    pages = T.MangaPageDataset(str(folder / "manga"))
    port, ref = T.BEGanDataset(str(folder / "data"), S), J.BEGanDataset(str(folder / "data"), S)
    port.synthesis_target = pages.load(0)
    ref.synthesis_target = J.MangaPageDataset(str(folder / "manga")).load(0)
    _assert_batches_equal(list(port.epoch_batches(2, 3)), list(ref.epoch_batches(2, 3)))
    plain = next(T.BEGanDataset(str(folder / "data"), S).epoch_batches(2, 3))
    assert not np.array_equal(next(port.epoch_batches(2, 3))["imgs"], plain["imgs"])


def test_manga_page_dataset_walks_the_titles(folder):
    port = T.MangaPageDataset(str(folder / "manga"))
    assert port.imgs == J.MangaPageDataset(str(folder / "manga")).imgs
    assert [os.path.basename(p) for p in port.imgs] == ["p0.png", "p1.png"]  # "Other" is no title
    assert len(T.MangaPageDataset(str(folder / "manga"), titles=("Other",))) == 1
    page = port.load(1)
    assert page.shape == (150, 120, 3) and page.dtype == np.float32
    np.testing.assert_array_equal(page, J.MangaPageDataset(str(folder / "manga")).load(1))


@pytest.mark.parametrize("select", [None, (1, 3)])
def test_be_gan_style_dataset_matches_jax(folder, select):
    """`_mask2` images, content masks and the labels {1, 2} -> 0, 3 -> 1."""
    port = T.BEGanStyleDataset(str(folder / "style"), S, select)
    ref = J.BEGanStyleDataset(str(folder / "style"), S, select)
    assert len(port) == len(ref) == (5 if select is None else 4)
    _assert_batches_equal(list(port.epoch_batches(2, 4)), list(ref.epoch_batches(2, 4)))
    assert sorted({it["label"] for it in port.items}) == ([0, 1])


def test_geometry_helpers_match_jax():
    m = np.zeros((20, 30), np.float32)
    m[4:9, 11:17] = 1
    assert T.bbox2(m) == J.bbox2(m) == (11, 4, 16, 8)
    for seed in range(4):
        assert (T.random_offset((11, 4, 16, 8), 30, np.random.default_rng(seed), maximum=5)
                == J.random_offset((11, 4, 16, 8), 30, np.random.default_rng(seed), maximum=5))
    arr = np.random.default_rng(1).uniform(size=(17, 23, 3)).astype(np.float32)
    np.testing.assert_array_equal(T._affine_nearest(arr, 12.5, (3, -2), 1.2, 1.0),
                                  J._affine_nearest(arr, 12.5, (3, -2), 1.2, 1.0))
