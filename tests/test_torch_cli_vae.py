"""The port's circle VAE-GAN trainer CLI (vaeplay_torch.cli.train_vae) on the
CPU: the run-dir layout, the PNG grid, metrics.jsonl and checkpoints, a
resume, the disk dataset mode in bf16, the profiler trace, a two-rank
--mesh 2x1 run that a one-rank run resumes, and its refusals (a mesh the
launched world cannot hold, no card without --device cpu)."""

import json
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

import torch_dist_workers as W
from vaeplay_torch.cli import train_vae
from vaeplay_torch.data.circles import CircleDataset, write_circle_dataset

IMG, BATCH = 64, 4


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two torch threads a process: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _train(tmp_path, name, *extra):
    return train_vae.main(["--device", "cpu", "--img_size", str(IMG), "--zdim", "16",
                           "--batchsize", str(BATCH), "--data_size", "8", "--viz_freq", "1",
                           "--epoch", "1", "--res_output", str(tmp_path / name / "results"),
                           "--model_output", str(tmp_path / name / "logs"), *extra])


def _lines(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _check_losses(lines):
    for r in lines:
        for k in train_vae.AVG_KEYS + ("kl", "nle", "images_per_sec"):
            assert math.isfinite(r[k]), (k, r)
        assert r["images_per_sec"] > 0


def test_train_writes_grid_metrics_checkpoint_and_resumes(tmp_path, capsys):
    """One epoch of 2 steps on on-device circles: the JAX CLI's layout
    (<model_output>/VAE/<timestamp>/ with metrics.jsonl and <epoch>.ckpt, a
    grid per --viz_freq step in res_output); then --resume goes on from the
    next epoch in a run dir of its own."""
    run = _train(tmp_path, "first")
    assert os.path.basename(os.path.dirname(run)) == "VAE"
    assert os.path.dirname(os.path.dirname(run)) == str(tmp_path / "first" / "logs")
    assert sorted(os.listdir(run)) == ["0.ckpt", "metrics.jsonl"]
    lines = _lines(run)
    assert [(r["step"], r["epoch"]) for r in lines] == [(1, 0), (2, 0)]
    _check_losses(lines)
    out = capsys.readouterr().out
    assert "epoch 0 it 2: loss_recon=" in out and "img/s" in out
    res = tmp_path / "first" / "results"
    assert sorted(os.listdir(res)) == ["0_0.png", "0_1.png"]
    # input | reconstruction | render(decoded params): 3 rows of BATCH panels, 2 px padding
    grid = np.asarray(Image.open(res / "0_1.png"))
    assert grid.shape == (3 * (IMG + 2) + 2, BATCH * (IMG + 2) + 2, 3)
    first_row = grid[2:2 + IMG, 2:2 + IMG, 0]
    assert set(np.unique(first_row)) == {0, 255}  # a rendered circle

    resumed = _train(tmp_path, "second", "--epoch", "2", "--resume", run)
    assert f"resumed epoch 0 from {run}" in capsys.readouterr().out
    assert sorted(os.listdir(resumed)) == ["1.ckpt", "metrics.jsonl"]
    assert [(r["step"], r["epoch"]) for r in _lines(resumed)] == [(3, 1), (4, 1)]
    ckpt = torch.load(os.path.join(resumed, "1.ckpt"), weights_only=True)
    assert ckpt["step"] == 4 and sorted(ckpt["optimizers"]) == sorted(
        ("encoder", "decoder", "discriminator", "param_encoder"))
    assert "encoder.conv.0.conv.weight" in ckpt["model"]


def test_disk_mode_in_bf16_with_remat_and_a_trace(tmp_path):
    """--path reads the reference's filename-encoded PNGs on 2 loader
    threads; --dtype bf16 and --remat run; --profile writes a trace of the
    first step."""
    data = tmp_path / "circles"
    write_circle_dataset(str(data), CircleDataset(n=IMG, data_size=8, seed=3))
    trace = tmp_path / "trace"
    run = _train(tmp_path, "disk", "--path", str(data), "--workers", "2", "--dtype", "bf16",
                 "--remat", "--profile", str(trace), "--profile_steps", "1")
    assert sorted(os.listdir(run)) == ["0.ckpt", "metrics.jsonl"]
    _check_losses(_lines(run))
    assert any(name.endswith(".json") for name in os.listdir(trace))
    for name, t in torch.load(os.path.join(run, "0.ckpt"), weights_only=True)["model"].items():
        assert not t.is_floating_point() or t.dtype == torch.float32, name
    os.makedirs(tmp_path / "nothing")
    with pytest.raises(ValueError, match="no filename-encoded circle files"):
        _train(tmp_path, "empty", "--path", str(tmp_path / "nothing"))


def test_refusals(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match=r"mesh 4x2 != 1 devices: .*torchrun --nproc_per_node 8"):
        _train(tmp_path, "mesh", "--mesh", "4x2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_vae.main(["--img_size", str(IMG), "--res_output", str(tmp_path / "r"),
                        "--model_output", str(tmp_path / "m")])


def test_two_rank_mesh_run_resumes_on_one_rank(tmp_path):
    """--mesh 2x1 over a 2-rank gloo world: rank 0 writes the run, whose
    first logged losses are a one-rank run's (the global batch's BatchNorm
    statistics, noise and sums); its checkpoint has a one-rank run's keys
    and shapes, and a one-rank --resume reads it."""
    args = ["--device", "cpu", "--img_size", str(IMG), "--zdim", "16", "--batchsize",
            str(BATCH), "--data_size", "8", "--viz_freq", "1", "--epoch", "1",
            "--res_output", str(tmp_path / "mesh" / "results"),
            "--model_output", str(tmp_path / "mesh" / "logs"), "--mesh", "2x1"]
    runs = W.run_world(W.cli_run, 2, tmp_path, "train_vae", args)
    assert runs[0] == runs[1]
    run = runs[0]
    assert sorted(os.listdir(run)) == ["0.ckpt", "metrics.jsonl"]
    one = _train(tmp_path, "one")
    mesh_lines, one_lines = _lines(run), _lines(one)
    assert [r["step"] for r in mesh_lines] == [r["step"] for r in one_lines] == [1, 2]
    for k in train_vae.AVG_KEYS:
        assert math.isclose(mesh_lines[0][k], one_lines[0][k], rel_tol=1e-4, abs_tol=1e-5), k
    saved = torch.load(os.path.join(run, "0.ckpt"), weights_only=True)
    want = torch.load(os.path.join(one, "0.ckpt"), weights_only=True)
    assert saved.keys() == want.keys()
    assert {k: t.shape for k, t in saved["model"].items()} == {
        k: t.shape for k, t in want["model"].items()}
    resumed = _train(tmp_path, "resumed", "--resume", run, "--epoch", "2")
    assert [r["epoch"] for r in _lines(resumed)] == [1, 1]
