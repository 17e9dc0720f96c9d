"""The port's BP CLIs (vaeplay_torch.cli.test_bp and train_bp) on the CPU,
their device rule, and the port's import boundary (no JAX, no vaeplay_tpu)."""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from vaeplay_torch.cli import test_bp, train_bp
from vaeplay_torch.device import resolve_device
from vaeplay_torch.models import bp

SMALL = ((16, 2), (32, 2), (64, 2), (64, 2), (64, 2), (64, 1), (64, 1))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two torch threads a process: the suite runs in several worker
    processes at once, and one thread per core in each slows the CPU
    training runs here many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def small_channels(monkeypatch):
    """The full-width emit pyramid is too heavy for the fast tier."""
    monkeypatch.setattr(bp, "EMIT_CHANNELS", SMALL)


def _pngs(paths):
    return [p for p in paths if p.endswith(".png") and os.path.isfile(p)]


def test_cli_synthetic_batch(small_channels, tmp_path):
    out = str(tmp_path / "bp")
    written = test_bp.main(["--device", "cpu", "--debug", "--img_size", "64",
                            "--batchsize", "2", "--res_output", out])
    assert _pngs(written) == [os.path.join(out, "emit.png")]
    # 2 rows of (input, points, rays) panels of 64 px with 2 px padding
    assert np.asarray(Image.open(written[0])).shape == (2 * 66 + 2, 3 * 66 + 2, 3)


@pytest.mark.slow
def test_cli_synthetic_batch_full_width(tmp_path):
    out = str(tmp_path / "bp")
    written = test_bp.main(["--device", "cpu", "--debug", "--img_size", "64",
                            "--batchsize", "2", "--res_output", out])
    assert _pngs(written)


def test_cli_walks_the_test_split(small_channels, tmp_path):
    d = tmp_path / "data" / "3"
    os.makedirs(d)
    gray = np.full((64, 64), 40, np.uint8)
    layer = np.zeros((64, 64, 3), np.uint8)
    layer[20:40, 20:40, 0] = 255
    for name in ("a", "b", "c"):
        Image.fromarray(gray).save(d / f"{name}.png")
        Image.fromarray(gray).save(d / f"{name}_mask2.png")
        Image.fromarray(layer).save(d / f"{name}_layer.png")
    out = str(tmp_path / "walk")
    written = test_bp.main(["--device", "cpu", "--debug", "--path", str(tmp_path / "data"),
                            "--img_size", "64", "--batchsize", "2", "--res_output", out])
    assert len(_pngs(written)) == 2  # 3 samples in batches of 2


def test_cli_model_path_reads_reference_state_dict(small_channels, tmp_path):
    """--model_path loads a torch.save'd state_dict with the reference's key
    names, dropping the reference's dead ellipse_predictor.convs tensors."""
    model = bp.ComposeNet(image_size=64, generator=torch.Generator().manual_seed(7))
    sd = dict(model.state_dict())
    sd["ellipse_predictor.convs.0.conv.0.weight"] = torch.zeros(256, 256, 3, 3)
    path = str(tmp_path / "bp.pt")
    torch.save(sd, path)
    loaded = test_bp.load_model(path, 64, torch.device("cpu"))
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    written = test_bp.main(["--device", "cpu", "--model_path", path, "--img_size", "64",
                            "--batchsize", "1", "--res_output", str(tmp_path / "out")])
    assert _pngs(written)


def test_no_cuda_raises_unless_cpu_is_asked_for(small_channels, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device(0, "cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_bp.main(["--debug", "--img_size", "64", "--res_output", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_bp.main(["--img_size", "64", "--iterations", "1",
                       "--res_output", str(tmp_path), "--model_output", str(tmp_path)])


def _train(tmp_path, name, *extra):
    return train_bp.main(["--device", "cpu", "--img_size", "64", "--batchsize", "2",
                          "--iterations", "2", "--viz_freq", "1",
                          "--res_output", str(tmp_path / name / "results"),
                          "--model_output", str(tmp_path / name / "logs"), *extra])


def test_train_cli_resume_and_render(small_channels, tmp_path, capsys):
    """Two iterations of the trainer on synthetic data, the reference's run
    layout, a resume into a second epoch, and test_bp rendering the run."""
    run = _train(tmp_path, "first")
    assert os.path.dirname(os.path.dirname(run)) == str(tmp_path / "first" / "logs")
    assert os.path.basename(os.path.dirname(run)) == "BP"
    assert sorted(os.listdir(run)) == ["0.ckpt", "metrics.jsonl", "record.txt"]
    with open(os.path.join(run, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [r["step"] for r in lines] == [1, 2] and all(r["epoch"] == 0 for r in lines)
    for r in lines:
        for k in train_bp.AVG_KEYS:
            assert math.isfinite(r[k]), (k, r)
    assert "loss_cx=" in capsys.readouterr().out

    resumed = _train(tmp_path, "second", "--epoch", "2", "--resume", run)
    assert "resumed epoch 0 from" in capsys.readouterr().out
    assert sorted(os.listdir(resumed)) == ["1.ckpt", "metrics.jsonl", "record.txt"]
    with open(os.path.join(resumed, "metrics.jsonl")) as f:
        assert [json.loads(line)["epoch"] for line in f] == [1, 1]
    ckpt = torch.load(os.path.join(resumed, "1.ckpt"), weights_only=True)
    assert ckpt["step"] == 8 and ckpt["scheduler"]["last_epoch"] == 8  # 2 epochs x 2 x 2

    written = test_bp.main(["--device", "cpu", "--model_path", resumed, "--img_size", "64",
                            "--batchsize", "1", "--res_output", str(tmp_path / "out")])
    assert _pngs(written)
    loaded = test_bp.load_model(resumed, 64, torch.device("cpu"))
    for k, v in ckpt["model"].items():
        assert torch.equal(loaded.state_dict()[k], v), k


def test_train_cli_bf16_epoch(small_channels, tmp_path):
    """--dtype bfloat16 trains an epoch of 2 iterations with finite logged
    losses, and saves an f32 checkpoint."""
    run = _train(tmp_path, "bf16", "--dtype", "bfloat16")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [r["step"] for r in lines] == [1, 2]
    assert all(math.isfinite(r[k]) for r in lines for k in train_bp.AVG_KEYS)
    with open(os.path.join(run, "record.txt")) as f:
        assert "bfloat16" in f.read()
    ckpt = torch.load(os.path.join(run, "0.ckpt"), weights_only=True)
    assert all(v.dtype == torch.float32 for v in ckpt["model"].values())


def test_port_imports_no_jax():
    """Every vaeplay_torch module (and chip_smoke) imports without pulling in
    jax, flax or vaeplay_tpu; checked in a fresh interpreter, since this test
    process has imported them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import vaeplay_torch, chip_smoke\n"
        "mods = [m.name for m in pkgutil.walk_packages(vaeplay_torch.__path__, 'vaeplay_torch.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'vaeplay_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 59  # every module was walked, BC's too
