"""The port's BE CLIs (vaeplay_torch.cli.train_be and test_be) on the CPU, with
the (1, 1, 1, 1) x 16 backbone: the run-dir layout, grids, metrics and
checkpoints, a resume, test_be on a run dir, a state_dict file and --debug,
the folder dataset in bf16 with a backbone file, and the device rule."""

import functools
import json
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

from vaeplay_torch.cli import test_be, train_be
from vaeplay_torch.models import be
from vaeplay_torch.models.backbone import ResNetFPN

IMG, BATCH = 64, 2
SLIM = functools.partial(be.ComposeNet, (1, 1, 1, 1), 16)


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
    monkeypatch.setattr(train_be, "ComposeNet", SLIM)
    monkeypatch.setattr(test_be, "ComposeNet", SLIM)


def _train(tmp_path, name, *extra):
    return train_be.main(["--device", "cpu", "--img_size", str(IMG), "--batchsize", str(BATCH),
                          "--iterations", "2", "--viz_freq", "1",
                          "--res_output", str(tmp_path / name / "results"),
                          "--model_output", str(tmp_path / name / "logs"), *extra])


def _lines(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _grids(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files if f.endswith(".png"))


def test_train_writes_run_and_resumes(slim, tmp_path, capsys):
    """One epoch of 2 iterations on bubbles rendered and augmented on the
    device: <model_output>/BE/<timestamp>/ with record.txt, metrics.jsonl and
    0.ckpt, a grid per --viz_freq iteration under <res_output>/BE/<timestamp>/;
    --resume goes on from the next epoch in a run dir of its own. The frozen
    stem never moves."""
    run = _train(tmp_path, "first")
    assert os.path.basename(os.path.dirname(run)) == "BE"
    assert os.path.dirname(os.path.dirname(run)) == str(tmp_path / "first" / "logs")
    assert sorted(os.listdir(run)) == ["0.ckpt", "metrics.jsonl", "record.txt"]
    lines = _lines(run)
    assert [(r["step"], r["epoch"]) for r in lines] == [(1, 0), (2, 0)]
    for r in lines:
        for k in ("loss_edge", "loss_mask", "images_per_sec"):
            assert math.isfinite(r[k]) and r[k] > 0, (k, r)
    out = capsys.readouterr().out
    assert "[epoch 0] it 2: loss_edge=" in out and "img/s" in out
    grids = _grids(tmp_path / "first" / "results")
    assert [os.path.basename(g) for g in grids] == ["0_1.png", "0_2.png"]
    # inputs, masks, edges: 3 rows of BATCH panels of IMG px, 2 px padding
    grid = np.asarray(Image.open(tmp_path / "first" / "results" / grids[1]))
    assert grid.shape == (3 * (IMG + 2) + 2, BATCH * (IMG + 2) + 2, 3)
    with open(os.path.join(run, "record.txt")) as f:
        assert "batchsize" in f.read()

    resumed = _train(tmp_path, "second", "--epoch", "2", "--resume", run)
    assert f"resumed epoch 0 from {run}" in capsys.readouterr().out
    assert sorted(os.listdir(resumed)) == ["1.ckpt", "metrics.jsonl", "record.txt"]
    assert [(r["step"], r["epoch"]) for r in _lines(resumed)] == [(3, 1), (4, 1)]
    ckpt = torch.load(os.path.join(resumed, "1.ckpt"), weights_only=True)
    assert ckpt["step"] == 4 and sorted(ckpt) == ["model", "optimizer", "scheduler", "step"]
    init = SLIM(generator=torch.Generator().manual_seed(0)).state_dict()
    for k in ("feature_net.backbone.body.conv1.weight",
              "feature_net.backbone.body.layer1.0.conv2.weight"):
        assert torch.equal(ckpt["model"][k], init[k]), k
    assert not torch.equal(ckpt["model"]["feature_net.backbone.body.layer2.0.conv2.weight"],
                           init["feature_net.backbone.body.layer2.0.conv2.weight"])


def test_test_be_reads_run_dirs_state_dicts_and_debug(slim, tmp_path):
    """--model_path takes a train_be run dir (its latest checkpoint's model)
    or a torch.save'd state_dict with the reference's keys; --debug an
    untrained net; each writes a grid per batch (two synthetic batches)."""
    run = _train(tmp_path, "run", "--iterations", "1")
    out = str(tmp_path / "out")
    written = test_be.main(["--device", "cpu", "--model_path", run, "--img_size", str(IMG),
                            "--batchsize", "2", "--res_output", out])
    assert written == [os.path.join(out, "test_0.png"), os.path.join(out, "test_1.png")]
    grid = np.asarray(Image.open(written[0]))
    assert grid.shape == (3 * (IMG + 2) + 2, 2 * (IMG + 2) + 2, 3)
    loaded = test_be.load_model(run, torch.device("cpu"))
    saved = torch.load(os.path.join(run, "0.ckpt"), weights_only=True)["model"]
    for k, v in saved.items():
        assert torch.equal(loaded.state_dict()[k], v), k
    assert not loaded.training

    path = str(tmp_path / "be.pt")
    torch.save(SLIM(generator=torch.Generator().manual_seed(3)).state_dict(), path)
    assert len(test_be.main(["--device", "cpu", "--model_path", path, "--img_size", str(IMG),
                             "--batchsize", "3", "--res_output", str(tmp_path / "sd")])) == 2
    assert len(test_be.main(["--device", "cpu", "--debug", "--img_size", str(IMG),
                             "--batchsize", "2", "--res_output", str(tmp_path / "dbg")])) == 2
    with pytest.raises(SystemExit):
        test_be.main(["--device", "cpu", "--res_output", str(tmp_path / "none")])


def _write_folder(root, size=IMG):
    rng = np.random.default_rng(0)
    for cls, names in (("1", ["a", "b"]), ("3", ["c"]), ("test", ["d", "e", "f"])):
        os.makedirs(os.path.join(root, cls))
        for name in names:
            Image.fromarray(rng.integers(0, 256, (size, size, 3), dtype=np.uint8)).save(
                os.path.join(root, cls, f"{name}.png"))
            layer = np.full((size, size, 3), 255, np.uint8)
            layer[10:40, 10:40] = (255, 0, 0)
            layer[8:10, 8:42] = (0, 255, 0)
            Image.fromarray(layer).save(os.path.join(root, cls, f"{name}_layer.png"))


def test_folder_data_in_bf16_with_a_backbone_file(slim, tmp_path, capsys):
    """--path reads the reference's class folders on 2 loader threads (3
    samples, batch 2: the epoch restarts after one batch); --dtype bf16 runs
    with f32 state; --backbone_ckpt loads a torchvision-layout file into the
    backbone first, so the frozen stem is the file's. test_be --path runs
    the "test" folder."""
    data = str(tmp_path / "data")
    _write_folder(data)
    source = ResNetFPN((1, 1, 1, 1), 16, generator=torch.Generator().manual_seed(11))
    bb = str(tmp_path / "resnet.pth")
    torch.save({"state_dict": source.state_dict()}, bb)
    run = _train(tmp_path, "disk", "--path", data, "--workers", "2", "--dtype", "bf16",
                 "--backbone_ckpt", bb)
    assert "loaded into 1 backbone(s)" in capsys.readouterr().out
    ckpt = torch.load(os.path.join(run, "0.ckpt"), weights_only=True)["model"]
    for k, v in ckpt.items():
        assert not v.is_floating_point() or v.dtype == torch.float32, k
    assert torch.equal(ckpt["feature_net.backbone.body.conv1.weight"], source.body.conv1.weight)
    assert torch.equal(ckpt["feature_net.backbone.body.layer1.0.bn2.running_var"],
                       source.body.layer1[0].bn2.running_var)
    assert all(math.isfinite(r["loss_mask"]) for r in _lines(run))
    written = test_be.main(["--device", "cpu", "--model_path", run, "--path", data,
                            "--img_size", str(IMG), "--batchsize", "2",
                            "--res_output", str(tmp_path / "walk")])
    assert len(written) == 2  # 3 test images in batches of 2


def test_no_cuda_raises_unless_cpu_is_asked_for(slim, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_be.main(["--debug", "--img_size", str(IMG), "--res_output", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_be.main(["--img_size", str(IMG), "--iterations", "1",
                       "--res_output", str(tmp_path), "--model_output", str(tmp_path)])
