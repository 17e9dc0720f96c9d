"""The port's font data (vaeplay_torch.data.font_data) against the JAX
package's (vaeplay_tpu.data.font_data): both are numpy and PIL, so for one
seed or one generator state every array and image is equal bit for bit.
The file-backed datasets run over a tiny tree under tmp_path."""

import json

import numpy as np
import pytest
from PIL import Image, ImageDraw

from vaeplay_torch.data import font_data as TD
from vaeplay_tpu.data import font_data as JD

IMG = 32


def _same_images(a, b):
    assert a.mode == b.mode and a.size == b.size
    assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seed,epoch", [(0, 0), (3, 2)])
def test_synthetic_batches_equal_jax(seed, epoch):
    """Two batches of 3 at 32 px: imgs, masks, edges, labels and styles
    equal, with the same dtypes and shapes."""
    got = list(TD.SyntheticGlyphDataset(data_size=6, seed=seed).batches(3, IMG, epoch))
    want = list(JD.SyntheticGlyphDataset(data_size=6, seed=seed).batches(3, IMG, epoch))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["edges", "imgs", "labels", "masks", "styles"]
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            assert np.array_equal(g[k], w[k]), k
    assert got[0]["imgs"].shape == (3, IMG, IMG, 3) and got[0]["masks"].shape == (3, IMG, IMG, 1)
    assert got[0]["styles"].shape == (3, 5) and got[0]["labels"].dtype == np.int64


@pytest.mark.parametrize("p", [0.2, 0.9], ids=["plain", "inverted"])
def test_augment_operator_equals_jax(p):
    """One glyph through AugmentOperator (scale, rotate, shear, white edge and,
    above OPPOSITE_THRES, the inversion) from one generator state: the four
    images equal."""
    img, mask, _ = JD.SyntheticGlyphDataset().glyph(np.random.default_rng(5))
    params = {"scale": 1.2, "angle": 7.0, "shear": -0.3, "kernel_size": 5, "p": p}
    got = TD.AugmentOperator()(img, mask, 512 * 512 * 30, params, np.random.default_rng(1))
    want = JD.AugmentOperator()(img, mask, 512 * 512 * 30, params, np.random.default_rng(1))
    for g, w in zip(got, want):
        _same_images(g, w)


def test_prepare_synthesis_equals_jax():
    """Four glyphs composited onto one page from one generator state: the
    crops, masks, edges and style vectors equal, and the generators end in
    the same state."""
    ds = JD.SyntheticGlyphDataset()
    rng = np.random.default_rng(11)
    page, target = ds.page(rng)
    glyphs = [ds.glyph(rng) for _ in range(4)]
    imgs, masks, _ = zip(*glyphs)
    r_got, r_want = np.random.default_rng(12), np.random.default_rng(12)
    got = TD.prepare_synthesis_data(page, target, imgs, masks, TD.AugmentOperator(), r_got)
    want = JD.prepare_synthesis_data(page, target, imgs, masks, JD.AugmentOperator(), r_want)
    for g_list, w_list in zip(got[:3], want[:3]):
        for g, w in zip(g_list, w_list):
            _same_images(g, w)
    assert got[3] == want[3]
    assert r_got.integers(0, 2**62) == r_want.integers(0, 2**62)


def test_to_n_n_pads_to_square():
    img = Image.new("L", (10, 4), 7)
    for a, b in ((TD.to_n_n(img, 255), JD.to_n_n(img, 255)),
                 (TD.to_n_n(img.transpose(Image.TRANSPOSE), 0),
                  JD.to_n_n(img.transpose(Image.TRANSPOSE), 0))):
        assert a.size == (10, 10)
        _same_images(a, b)


@pytest.fixture()
def tiny_tree(tmp_path):
    """save_folder/<style>/<codepoint>.png glyphs (two styles), two pages
    with labelme JSONs (one with Bubble and Onomatopoeia-Kana boxes and a
    manga109 entry, one with no occupied box), the page list, and a kana
    folder of three crops."""
    fonts = tmp_path / "save_folder"
    rng = np.random.default_rng(0)
    for style in ("a_style", "b_style"):
        (fonts / style).mkdir(parents=True)
        for code in (3, 10):
            im = Image.new("L", (40, 40), 255)
            ImageDraw.Draw(im).ellipse([8, 8, 8 + code, 30], fill=0)
            im.save(fonts / style / f"{code}.png")
    pages = tmp_path / "pages"
    pages.mkdir()
    entries = []
    for i, shapes in enumerate((
            [{"label": "Bubble", "points": [[30, 20], [5, 60]]},
             {"label": "Onomatopoeia-Kana", "points": [[100, 110], [150, 190]]},
             {"label": "Text", "points": [[0, 0], [10, 10]]}],
            [{"label": "Text", "points": [[0, 0], [10, 10]]}])):
        arr = (rng.uniform(size=(200, 160)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(pages / f"p{i}.png")
        with open(pages / f"p{i}.json", "w") as f:
            json.dump({"imageWidth": 160, "imageHeight": 200, "imagePath": f"p{i}.png",
                       "shapes": shapes}, f)
        entries.append({"annotation_path": str(pages / f"p{i}.json"),
                        "manga_folder": str(pages), "data_type": "manga109"})
    page_list = tmp_path / "training_data.json"
    with open(page_list, "w") as f:
        json.dump(entries, f)
    kana = tmp_path / "kana"
    kana.mkdir()
    for i in range(3):
        Image.fromarray((rng.uniform(size=(20 + 5 * i, 30)) * 255).astype(np.uint8)).save(
            kana / f"k{i}.png")
    return str(fonts), str(page_list), str(kana)


def test_file_datasets_equal_jax(tiny_tree):
    """FEDataset (labels = codepoint + 1), ImageDatasetJson (only pages with
    an occupied box; a manga109 page's area halved) and KanaImageDataset
    (binarized, white-padded, squared) load what the JAX package's do."""
    fonts, page_list, kana = tiny_tree
    fe_t, fe_j = TD.FEDataset(fonts), JD.FEDataset(fonts)
    assert fe_t.labels == fe_j.labels == [11, 4, 11, 4]  # "10.png" sorts first
    for i in range(len(fe_j)):
        got, want = fe_t.load(i), fe_j.load(i)
        _same_images(got[0], want[0])
        _same_images(got[1], want[1])
        assert got[2] == want[2]
    pg_t, pg_j = TD.ImageDatasetJson(page_list), JD.ImageDatasetJson(page_list)
    assert len(pg_t) == len(pg_j) == 1
    (img_t, tgt_t), (img_j, tgt_j) = pg_t.load(0), pg_j.load(0)
    _same_images(img_t, img_j)
    assert tgt_t["real_page_area"] == tgt_j["real_page_area"] == 160 * 200 / 2
    assert np.array_equal(tgt_t["occupied_boxes"], [[5, 20, 30, 60], [100, 110, 150, 190]])
    assert set(np.unique(np.asarray(img_t))) <= {0, 255}
    kn_t, kn_j = TD.KanaImageDataset(kana), JD.KanaImageDataset(kana)
    assert len(kn_t) == len(kn_j) == 3
    for i in range(3):
        got = kn_t.load(i)
        _same_images(got, kn_j.load(i))
        assert got.size[0] == got.size[1] == 30 + 22


def test_real_data_batches_equal_jax_recipe(tiny_tree):
    """The port trainer's real-data path gives the JAX CLI's batch for one
    seed and epoch: the same glyph order, page draw and composite."""
    from vaeplay_torch.cli.train_be_font import real_data_batches

    fonts, page_list, _ = tiny_tree
    (got,) = list(real_data_batches(fonts, page_list, 4, IMG, seed=2)(1))
    fe, pages = JD.FEDataset(fonts), JD.ImageDatasetJson(page_list)
    rng = np.random.default_rng((2, 1))
    order = rng.permutation(len(fe))
    base, target = pages.load(int(rng.integers(0, len(pages))))
    imgs, masks, labels = zip(*(fe.load(j) for j in order[:4]))
    t_imgs, t_masks, t_edges, t_styles = JD.prepare_synthesis_data(
        base, target, imgs, masks, JD.AugmentOperator(), rng)
    resize = lambda pil: np.asarray(pil.resize((IMG, IMG), Image.BILINEAR), np.float32) / 255.0
    assert np.array_equal(got["imgs"], np.stack([resize(x.convert("RGB")) for x in t_imgs]))
    assert np.array_equal(got["masks"], np.stack([resize(x)[..., None] for x in t_masks]))
    assert np.array_equal(got["edges"], np.stack([resize(x)[..., None] for x in t_edges]))
    assert got["labels"].tolist() == list(labels)
    assert np.array_equal(got["styles"], np.asarray(t_styles, np.float32))

