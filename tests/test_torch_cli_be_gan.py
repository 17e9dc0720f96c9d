"""The port's BE serving and BE_GAN CLIs on the CPU, with the (1, 1, 1, 1) x
16 backbone: train_be_gan (run-dir layout, grids, metrics, the whole
GanState per epoch, a resume), test_be_gan_manga on its run dir,
test_be_manga on both page routes, test_be's --model_path forms (a run dir,
`<run dir>/<epoch>`, a checkpoint file, a bare state_dict), and the device
rule."""

import functools
import json
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

from vaeplay_torch.cli import test_be, test_be_gan_manga, test_be_manga, train_be, train_be_gan
from vaeplay_torch.models import be, be_gan

GAN_IMG, SERVE_IMG, BATCH = 128, 64, 2
SLIM_BE = functools.partial(be.ComposeNet, (1, 1, 1, 1), 16)
SLIM_G = functools.partial(be_gan.ComposeNet, (1, 1, 1, 1), 16)


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two torch threads a process: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def slim(monkeypatch):
    """The full-width ResNet50 is too heavy for the fast tier."""
    for mod in (train_be, test_be):
        monkeypatch.setattr(mod, "ComposeNet", SLIM_BE)
    for mod in (train_be_gan, test_be_gan_manga):
        monkeypatch.setattr(mod, "ComposeNet", SLIM_G)


@pytest.fixture()
def manga_tree(tmp_path):
    """<root>/manga/M/ep1/ch1/OriginSizeManga/p{0,1,2}.png with drawn
    bubbles, their OriginSizeBubbles masks, and labelme annotations for p0
    and p1 under <root>/anno."""
    rng = np.random.default_rng(0)
    chapter = tmp_path / "manga" / "M" / "ep1" / "ch1"
    anno_dir = tmp_path / "anno" / "M" / "ep1" / "ch1"
    for d in (chapter / "OriginSizeManga", chapter / "OriginSizeBubbles", anno_dir):
        os.makedirs(d)
    for p in range(3):
        page = Image.new("RGB", (300, 260), (235, 235, 235))
        mask = Image.new("RGB", (300, 260), (255, 255, 255))
        draw, mdraw, shapes = ImageDraw.Draw(page), ImageDraw.Draw(mask), []
        for b, (cx, cy) in enumerate(((80, 70), (210, 180))):
            rx, ry = (int(v) for v in rng.integers(25, 45, 2))
            box = [cx - rx, cy - ry, cx + rx, cy + ry]
            draw.ellipse(box, fill=(255, 255, 255), outline=(0, 0, 0), width=3)
            mdraw.ellipse(box, fill=(255, b + 1, 0))
            shapes.append({"label": "Bubble-Boundary", "sub_label": ("Oval", "NoFrame")[b],
                           "points": [box[:2], box[2:]]})
        page.save(chapter / "OriginSizeManga" / f"p{p}.png")
        mask.save(chapter / "OriginSizeBubbles" / f"p{p}.png")
        if p < 2:
            with open(anno_dir / f"p{p}.json", "w") as f:
                json.dump({"imageWidth": 300, "imageHeight": 260, "shapes": shapes}, f)
    return str(tmp_path / "manga"), str(tmp_path / "anno")


def _pngs(out):
    return sorted(f for f in os.listdir(out) if f.endswith(".png"))


def _train_gan(tmp_path, name, *extra):
    return train_be_gan.main(["--device", "cpu", "--img_size", str(GAN_IMG), "--batchsize",
                              str(BATCH), "--iterations", "2", "--viz_freq", "1", "--epochs", "1",
                              "--res_output", str(tmp_path / name / "results"),
                              "--model_output", str(tmp_path / name / "logs"), *extra])


def test_train_be_gan_resumes_and_serves_pages(slim, tmp_path, manga_tree, capsys):
    """One epoch of 2 iterations on bubbles rendered on the device:
    <model_output>/BE_GAN/<timestamp>/ with record.txt, metrics.jsonl (the
    seven losses, finite) and 0.ckpt (both models, both optimizers), a G grid
    per --viz_freq iteration; --resume goes on from epoch 1; then
    test_be_gan_manga serves the annotated pages from the resumed run dir."""
    run = _train_gan(tmp_path, "first")
    assert os.path.basename(os.path.dirname(run)) == "BE_GAN"
    assert sorted(os.listdir(run)) == ["0.ckpt", "metrics.jsonl", "record.txt"]
    with open(os.path.join(run, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [(r["step"], r["epoch"]) for r in lines] == [(1, 0), (2, 0)]
    for r in lines:
        for k in train_be_gan.METRIC_KEYS:
            assert math.isfinite(r[k]), (k, r)
    assert "d_adv_loss=" in capsys.readouterr().out
    grids = os.listdir(os.path.join(str(tmp_path / "first" / "results"), "BE_GAN",
                                    os.path.basename(run)))
    assert sorted(grids) == ["0_1_wgtm.png", "0_2_wgtm.png"]
    ckpt = torch.load(os.path.join(run, "0.ckpt"), weights_only=True)
    assert sorted(ckpt) == ["d", "g"] and ckpt["g"]["step"] == ckpt["d"]["step"] == 2
    assert ckpt["d"]["optimizer"]["param_groups"][0]["lr"] == pytest.approx(1e-5)
    assert tuple(ckpt["g"]["optimizer"]["param_groups"][0]["betas"]) == (0.5, 0.999)

    resumed = _train_gan(tmp_path, "second", "--epochs", "2", "--resume", run)
    assert f"resumed epoch 0 from {run}" in capsys.readouterr().out
    assert sorted(os.listdir(resumed)) == ["1.ckpt", "metrics.jsonl", "record.txt"]
    assert torch.load(os.path.join(resumed, "1.ckpt"), weights_only=True)["g"]["step"] == 4

    root, anno = manga_tree
    out = str(tmp_path / "served")
    stats = test_be_gan_manga.main(["--device", "cpu", "--path", root, "--anno_path", anno,
                                    "--model_path", resumed, "--img_size", str(SERVE_IMG),
                                    "--res_output", out])
    assert tuple(stats) == (2, 0, 0) and _pngs(out) == ["M_ep1_ch1_p0.png", "M_ep1_ch1_p1.png"]
    g = test_be_gan_manga.load_generator(os.path.join(resumed, "1"), torch.device("cpu"))
    saved = torch.load(os.path.join(resumed, "1.ckpt"), weights_only=True)["g"]["model"]
    for k, v in saved.items():
        assert torch.equal(g.state_dict()[k], v), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_test_be_manga_serves_both_routes(slim, tmp_path, manga_tree, dtype):
    """--debug serves the seed-0 net: the annotated pages through the
    annotation route (the NoFrame bubble pasted as its box, class 3; white
    outside every box), the third page through its coarse mask (the second
    bubble's content is its mask, class 2); every page writes a PNG of the
    page's size."""
    root, anno = manga_tree
    out = str(tmp_path / "out")
    stats = test_be_manga.main(["--device", "cpu", "--debug", "--path", root, "--anno_path", anno,
                                "--img_size", str(SERVE_IMG), "--res_output", out,
                                "--dtype", dtype])
    assert tuple(stats) == (3, 0, 0)
    assert _pngs(out) == [f"M_ep1_ch1_p{p}.png" for p in range(3)]
    for p, name in enumerate(_pngs(out)):
        res = np.asarray(Image.open(os.path.join(out, name)))
        assert res.shape == (260, 300, 3)
        label = 3 if p < 2 else 2
        assert ((res[:, :, 1] == label) & (res[:, :, 0] == 255)).any(), name
        assert p == 2 or (res[259, 0] == 255).all(), name
    jobs = test_be_manga.page_jobs(root, None)
    assert [j.mask_path is not None for j in jobs] == [True] * 3
    assert len(test_be_manga.page_jobs(root, anno, annotated_only=True)) == 2


def test_test_be_reads_every_model_path_form(slim, tmp_path):
    """One CPU epoch of train_be, then test_be.load_model by the run dir (its
    latest epoch), by `<run dir>/<epoch>`, by the checkpoint file itself
    (its "model" entry) and by a bare state_dict; a missing epoch raises."""
    run = train_be.main(["--device", "cpu", "--img_size", "64", "--batchsize", "2",
                         "--iterations", "1", "--viz_freq", "1",
                         "--res_output", str(tmp_path / "results"),
                         "--model_output", str(tmp_path / "logs")])
    saved = torch.load(os.path.join(run, "0.ckpt"), weights_only=True)["model"]
    bare = str(tmp_path / "be.pt")
    torch.save(saved, bare)
    cpu = torch.device("cpu")
    for path in (run, os.path.join(run, "0"), os.path.join(run, "0.ckpt"), bare):
        model = test_be.load_model(path, cpu)
        for k, v in saved.items():
            assert torch.equal(model.state_dict()[k], v), (path, k)
        assert not model.training
    with pytest.raises(FileNotFoundError, match="epoch 3"):
        test_be.load_model(os.path.join(run, "3"), cpu)
    written = test_be.main(["--device", "cpu", "--model_path", os.path.join(run, "0"),
                            "--img_size", "64", "--batchsize", "2",
                            "--res_output", str(tmp_path / "grids")])
    assert len(written) == 2


def test_no_cuda_raises_unless_cpu_is_asked_for(slim, monkeypatch, tmp_path, manga_tree):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, anno = manga_tree
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_be_manga.main(["--debug", "--path", root, "--res_output", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_be_gan_manga.main(["--debug", "--path", root, "--anno_path", anno,
                                "--res_output", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_be_gan.main(["--img_size", str(GAN_IMG), "--iterations", "1",
                           "--res_output", str(tmp_path), "--model_output", str(tmp_path)])
