"""The port's manga-page pipeline (vaeplay_torch.eval.manga and eval.serve)
against the JAX package's eval/manga.py on a synthetic page: both load
routes, both pastes (the written PNG files byte for byte), NoFrame dilation,
and serve_pages against the sequential loop, with bad and empty pages.
Mirrors tests/test_manga_pipeline.py."""

import json
import os

import numpy as np
import pytest
from PIL import Image

from vaeplay_torch.eval import manga as TM
from vaeplay_torch.eval.serve import PageJob, load_page, paste_page, serve_pages
from vaeplay_tpu.eval import manga as JM

S = 64  # crop size


@pytest.fixture
def synthetic_page(tmp_path):
    """A 256 x 300 page with three bubbles (one NoFrame), its coarse mask
    (bubble pixels (255, label, 0) on white) and a labelme annotation."""
    h, w = 256, 300
    img = np.full((h, w, 3), 200, np.uint8)
    mask = np.full((h, w, 3), 255, np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    shapes = []
    for (cx, cy, r, label, sub) in ((70, 80, 30, 1, "Oval"), (180, 170, 25, 2, "Explosion"),
                                    (250, 60, 20, 3, "NoFrame")):
        inside = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
        img[inside] = 255
        mask[inside] = (255, label, 0)
        shapes.append({"label": "Bubble-Boundary", "sub_label": sub,
                       "points": [[cx + r, cy + r], [cx - r, cy - r]]})
    shapes.append({"label": "Text", "points": [[0, 0], [5, 5]]})
    paths = {k: str(tmp_path / f"page_{k}.png") for k in ("img", "mask")}
    Image.fromarray(img).save(paths["img"])
    Image.fromarray(mask).save(paths["mask"])
    paths["anno"] = str(tmp_path / "page.json")
    with open(paths["anno"], "w") as f:
        json.dump({"imageWidth": w, "imageHeight": h, "shapes": shapes}, f)
    return paths, tmp_path


def _preds(n, seed=0):
    r = np.random.default_rng(seed)
    return {"masks": (r.uniform(size=(n, S, S, 1)) > 0.4).astype(np.float32),
            "edges": (r.uniform(size=(n, S, S, 1)) > 0.6).astype(np.float32)}


def _assert_pages_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if k == "masks":
            assert len(got[k]) == len(w) and all(np.array_equal(a, b) for a, b in zip(got[k], w))
        elif w is None:
            assert got[k] is None
        else:
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("route", ["mask", "annotation"])
def test_load_routes_match_jax(synthetic_page, route):
    """Crops (uint8), boxes, labels, reconstruction info and masks equal the
    JAX module's."""
    paths, _ = synthetic_page
    if route == "mask":
        got = TM.load_manga_from_mask(paths["img"], paths["mask"], S)
        want = JM.load_manga_from_mask(paths["img"], paths["mask"], S)
        assert sorted(got["labels"].tolist()) == [1, 2, 3]
    else:
        got = TM.load_manga_from_annotation(paths["img"], paths["anno"], S)
        want = JM.load_manga_from_annotation(paths["img"], paths["anno"], S)
        assert got["labels"].tolist() == [1, 2, 3] and got["original_boxes"].shape == (3, 4)
    assert got["images"].shape == (3, S, S, 3) and got["images"].dtype == np.uint8
    _assert_pages_equal(got, want)


@pytest.mark.parametrize("route", ["mask", "annotation"])
def test_paste_writes_the_jax_png_bytes(synthetic_page, route):
    """paste_result_on_manga (annotation route) and
    paste_edge_result_on_manga (mask route): the same array and the same
    PNG file, byte for byte, as the JAX module for the same predictions."""
    paths, tmp = synthetic_page
    out = {}
    for side, mod in (("port", TM), ("jax", JM)):
        res = str(tmp / side)
        if route == "mask":
            page = mod.load_manga_from_mask(paths["img"], paths["mask"], S)
            arr = mod.paste_edge_result_on_manga(paths["img"], page, _preds(3)["edges"], res, "r")
        else:
            page = mod.load_manga_from_annotation(paths["img"], paths["anno"], S)
            p = _preds(3)
            arr = mod.paste_result_on_manga(paths["img"], page, p["masks"], p["edges"], res, "r")
        with open(os.path.join(res, "r.png"), "rb") as f:
            out[side] = (arr, f.read())
    np.testing.assert_array_equal(out["port"][0], out["jax"][0])
    assert out["port"][1] == out["jax"][1]
    assert out["port"][0].shape == (256, 300, 3) and (out["port"][0][0, 0] == 255).all()


def test_noframe_paints_its_dilated_box(synthetic_page):
    """With empty predictions the NoFrame bubble (label 3) still paints its
    box, and the 13 px dilation around it as edge (blue channel)."""
    paths, tmp = synthetic_page
    page = TM.load_manga_from_annotation(paths["img"], paths["anno"], S)
    zeros = np.zeros((3, S, S, 1), np.float32)
    out = TM.paste_result_on_manga(paths["img"], page, zeros, zeros, str(tmp), "nf")
    content = (out[:, :, 1] == 3) & (out[:, :, 0] == 255)
    edge = (out[:, :, 1] == 3) & (out[:, :, 2] == 255)
    assert content.sum() == 40 * 40  # the original box, (230, 40) to (270, 80)
    assert edge.sum() == 52 * 52 - 40 * 40  # 6 px of dilation on each side
    assert not ((out[:, :, 1] == 1) | (out[:, :, 1] == 2)).any()


def test_dilate_and_resize_match_jax():
    m = (np.random.default_rng(0).uniform(size=(20, 24)) < 0.05).astype(np.float32)
    np.testing.assert_array_equal(TM._dilate(m, 5), JM._dilate(m, 5))
    u = (np.random.default_rng(1).uniform(size=(S, S, 1)) < 0.5).astype(np.float32)
    np.testing.assert_array_equal(TM._resize_nearest(u, 97), JM._resize_nearest(u, 97))


def test_serve_pages_matches_sequential_and_skips_bad_pages(synthetic_page, tmp_path_factory):
    """serve_pages writes the files the sequential load -> predict -> paste
    loop writes, on both routes; a page that fails to load is skipped and
    counted, a page with no bubble counted as empty."""
    paths, tmp = synthetic_page
    blank = str(tmp / "blank_mask.png")
    Image.fromarray(np.full((256, 300, 3), 255, np.uint8)).save(blank)

    def predict(imgs):
        return _preds(imgs.shape[0], seed=imgs.shape[0])

    jobs = [PageJob(paths["img"], paths["anno"], None, "anno_route"),
            PageJob(paths["img"], None, paths["mask"], "mask_route"),
            PageJob("/nonexistent/page.png", paths["anno"], None, "bad"),
            PageJob(paths["img"], None, blank, "empty"),
            PageJob(paths["img"], paths["anno"], None, "anno_route_2")]
    seq = str(tmp_path_factory.mktemp("seq"))
    for j in jobs[:2] + jobs[4:]:
        page = load_page(j, S)
        paste_page(j, page, predict(page["images"]), seq)
    pipe = str(tmp_path_factory.mktemp("pipe"))
    stats = serve_pages(predict, jobs, S, pipe)
    assert (stats.written, stats.empty, stats.failed) == (3, 1, 1)
    assert sorted(os.listdir(pipe)) == ["anno_route.png", "anno_route_2.png", "mask_route.png"]
    for name in os.listdir(pipe):
        with open(os.path.join(pipe, name), "rb") as a, open(os.path.join(seq, name), "rb") as b:
            assert a.read() == b.read(), name
