"""The port's BE_font CLIs (vaeplay_torch.cli.train_be_font and
test_be_font) on the CPU at 32 px, batch 2, with a slim G (max_channel 64)
and D at its fixed widths: the run dir, metrics and the whole FontState
checkpointed every epoch, a resume, bf16, the real-data path over a tiny
glyph and page tree, test_be_font on every --model_path form and over a
kana folder, and the runs that raise without a card."""

import functools
import json
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_font_data import tiny_tree  # noqa: F401 (a fixture)
from vaeplay_torch.cli import test_be_font, train_be_font
from vaeplay_torch.models import be_font
from vaeplay_torch.train.steps_be_font import AVG_KEYS

IMG, BATCH = 32, 2
SLIM = functools.partial(be_font.ComposeNet, max_channel=64)


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def slim(monkeypatch):
    """The full-width relay FCs (8192 wide) are too heavy for the fast tier."""
    monkeypatch.setattr(train_be_font, "ComposeNet", SLIM)
    monkeypatch.setattr(test_be_font, "ComposeNet", SLIM)


def _train(tmp_path, name, *extra):
    return train_be_font.main(["--device", "cpu", "--img_size", str(IMG), "--batchsize",
                               str(BATCH), "--iterations", "2", "--viz_freq", "2",
                               "--res_output", str(tmp_path / name / "results"),
                               "--model_output", str(tmp_path / name / "logs"), *extra])


def _lines(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_writes_run_and_resumes(slim, monkeypatch, tmp_path, capsys):
    """One epoch of 2 iterations: <model_output>/BE_font/<timestamp>/ with
    record.txt, metrics.jsonl (the eight averaged losses, finite) and 0.ckpt,
    the whole FontState (g, style, d); a resume (strict) for a second epoch
    writes 1.ckpt in a run dir of its own, the three step counts going on."""
    run = _train(tmp_path, "a", "--epoch", "1")
    assert os.path.basename(os.path.dirname(run)) == "BE_font"
    assert sorted(os.listdir(run)) == ["0.ckpt", "metrics.jsonl", "record.txt"]
    (line,) = _lines(run)
    assert line["epoch"] == 0 and line["step"] == 2
    assert all(math.isfinite(line[k]) for k in AVG_KEYS)
    with open(os.path.join(run, "record.txt")) as f:
        assert "fonts_path" in f.read()
    out = capsys.readouterr().out
    assert "synthetic glyph synthesis" in out and "Epoch [0][2] loss_edge=" in out
    assert "GiB in" in out
    resumed = _train(tmp_path, "b", "--epoch", "2", "--resume", run)
    assert "resumed epoch 0" in capsys.readouterr().out
    assert sorted(os.listdir(resumed)) == ["1.ckpt", "metrics.jsonl", "record.txt"]
    assert [r["epoch"] for r in _lines(resumed)] == [1]
    saved = torch.load(os.path.join(resumed, "1.ckpt"), weights_only=True)
    assert sorted(saved) == ["d", "g", "style"]
    assert saved["g"]["step"] == saved["style"]["step"] == saved["d"]["step"] == 4
    for net in ("g", "style", "d"):
        assert saved[net]["optimizer"]["param_groups"][0]["lr"] == 1e-4
        assert saved[net]["optimizer"]["param_groups"][0]["betas"] == (0.9, 0.999)
    assert sorted(saved["style"]["model"]) == sorted(
        k[len("style_encoder."):] for k in saved["g"]["model"] if k.startswith("style_encoder."))
    monkeypatch.setattr(train_be_font, "ComposeNet",
                        functools.partial(be_font.ComposeNet, max_channel=128))
    with pytest.raises(RuntimeError, match="size mismatch"):  # strict: a G of other widths
        _train(tmp_path, "c", "--epoch", "3", "--resume", resumed)


def test_bf16_over_real_data(slim, tiny_tree, tmp_path):  # noqa: F811
    """--dtype bfloat16 with --fonts_path and --pages_json: the real-data
    path (4 glyphs, batch 2: 2 iterations) trains with finite losses and
    saves an f32 checkpoint."""
    fonts, pages, _ = tiny_tree
    run = _train(tmp_path, "real", "--epoch", "1", "--dtype", "bfloat16",
                 "--fonts_path", fonts, "--pages_json", pages)
    (line,) = _lines(run)
    assert line["step"] == 2 and all(math.isfinite(line[k]) for k in AVG_KEYS)
    saved = torch.load(os.path.join(run, "0.ckpt"), weights_only=True)
    for net in ("g", "d"):
        for k, v in saved[net]["model"].items():
            assert v.dtype in (torch.float32, torch.int64), k


def test_test_be_font_reads_every_model_path_form(slim, tiny_tree, tmp_path):  # noqa: F811
    """--model_path: a run dir (its latest checkpoint), <run dir>/<epoch>, a
    checkpoint file (its `g`) and a bare state_dict; --debug alone the
    seed-0 init. Each writes font.png, 7 rows of the batch of 8 (images,
    true masks, masks with labels, masks self-encoded, true edges, edges
    with labels, edges self-encoded). --path walks a kana folder of 3 in
    batches of 2 on the self-encoded path: test_0.png and test_1.png, 3 rows
    each. The net is in eval mode with the run's weights."""
    run = _train(tmp_path, "r", "--epoch", "1", "--iterations", "1", "--viz_freq", "1")
    sd_path = str(tmp_path / "g.pt")
    torch.save(SLIM(IMG, generator=torch.Generator().manual_seed(3)).state_dict(), sd_path)
    for i, path in enumerate((run, os.path.join(run, "0"), os.path.join(run, "0.ckpt"), sd_path,
                              None)):
        out = str(tmp_path / f"out{i}")
        args = ["--device", "cpu", "--img_size", str(IMG), "--res_output", out]
        written = test_be_font.main(args + (["--model_path", path] if path else ["--debug"]))
        assert written == [os.path.join(out, "font.png")]
        grid = np.asarray(Image.open(written[0]))
        assert grid.shape == (7 * (IMG + 2) + 2, 8 * (IMG + 2) + 2, 3)
    ckpt = torch.load(os.path.join(run, "0.ckpt"), weights_only=True)["g"]["model"]
    loaded = test_be_font.load_model(os.path.join(run, "0"), IMG, torch.device("cpu"))
    for k, v in ckpt.items():
        assert torch.equal(loaded.state_dict()[k], v), k
    assert not loaded.training
    _, _, kana = tiny_tree
    written = test_be_font.main(["--device", "cpu", "--img_size", str(IMG), "--model_path", run,
                                 "--path", kana, "--batchsize", "2",
                                 "--res_output", str(tmp_path / "walk")])
    assert [os.path.basename(p) for p in written] == ["test_0.png", "test_1.png"]
    assert np.asarray(Image.open(written[0])).shape == (3 * (IMG + 2) + 2, 2 * (IMG + 2) + 2, 3)
    assert np.asarray(Image.open(written[1])).shape == (3 * (IMG + 2) + 2, 1 * (IMG + 2) + 2, 3)
    with pytest.raises(SystemExit):
        test_be_font.main(["--device", "cpu", "--res_output", str(tmp_path / "none")])


def test_predict_paths_differ_and_stay_in_range(slim):
    """predict: sigmoid maps in [0, 1]; with labels and styles the class
    path, without them the self-encoded one, which differ."""
    model = test_be_font.load_model(None, IMG, torch.device("cpu"))
    rng = np.random.default_rng(0)
    imgs = rng.uniform(size=(2, IMG, IMG, 3)).astype(np.float32)
    labels, styles = np.asarray([1, 50]), rng.normal(size=(2, 5)).astype(np.float32)
    a = test_be_font.predict(model, imgs, torch.device("cpu"), labels, styles)
    b = test_be_font.predict(model, imgs, torch.device("cpu"))
    for p in (a, b):
        assert p["masks"].shape == p["edges"].shape == (2, 1, IMG, IMG)
        assert float(p["masks"].min()) >= 0 and float(p["masks"].max()) <= 1
    assert not torch.allclose(a["masks"], b["masks"])


def test_no_cuda_raises(slim, monkeypatch, tmp_path):
    """Without a card and without --device cpu, both CLIs raise instead of
    falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_be_font.main(["--debug", "--img_size", str(IMG), "--res_output", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_be_font.main(["--img_size", str(IMG), "--iterations", "1",
                            "--res_output", str(tmp_path), "--model_output", str(tmp_path)])
