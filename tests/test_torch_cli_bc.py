"""The port's BC CLIs (vaeplay_torch.cli.train_bc and test_bc) on the CPU,
with the (1, 1, 1, 1) x 16 backbone at 64 px and 16 contour points: the run
dir, metrics and checkpoints (the reference's epoch-10 rule), a resume,
bf16 compute with bf16 refine layers, test_bc on every --model_path form,
--path on both CLIs, and the flags that raise."""

import functools
import json
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

import torch_dist_workers as W
from vaeplay_torch.cli import test_bc, train_bc
from vaeplay_torch.models import bc

IMG, BATCH, MP = 64, 2, 16
SLIM = functools.partial(bc.ComposeNet, backbone_layers=(1, 1, 1, 1), backbone_width=16)


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def slim(monkeypatch):
    """The full-width ResNet50 is too heavy for the fast tier."""
    monkeypatch.setattr(train_bc, "ComposeNet", SLIM)
    monkeypatch.setattr(test_bc, "ComposeNet", SLIM)


def _train(tmp_path, name, *extra):
    return train_bc.main(["--device", "cpu", "--img_size", str(IMG), "--batchsize", str(BATCH),
                          "--max_points", str(MP), "--iterations", "2", "--viz_freq", "2",
                          "--res_output", str(tmp_path / name / "results"),
                          "--model_output", str(tmp_path / name / "logs"), *extra])


def _lines(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_writes_run_and_resumes(slim, tmp_path, capsys):
    """One epoch of 2 iterations: <model_output>/BC/<timestamp>/ with
    record.txt, metrics.jsonl (finite losses, the host trace's ms) and
    0.ckpt; a resume for a second epoch writes 1.ckpt in a run dir of its
    own, its Adam step count going on from the first run's."""
    run = _train(tmp_path, "a", "--epoch", "1")
    assert os.path.basename(os.path.dirname(run)) == "BC"
    assert sorted(os.listdir(run)) == ["0.ckpt", "metrics.jsonl", "record.txt"]
    (line,) = _lines(run)
    assert line["epoch"] == 0 and line["step"] == 2
    assert all(math.isfinite(line[k]) for k in ("loss_edge", "loss_mask", "loss_regress"))
    assert line["trace_ms_per_iteration"] > 0
    out = capsys.readouterr().out
    assert "synthetic BC dataset" in out and "epoch[0] loss_edge=" in out and "GiB in" in out
    resumed = _train(tmp_path, "b", "--epoch", "2", "--resume", run)
    assert "resumed epoch 0" in capsys.readouterr().out
    assert sorted(os.listdir(resumed)) == ["1.ckpt", "metrics.jsonl", "record.txt"]
    assert [r["epoch"] for r in _lines(resumed)] == [1]
    saved = torch.load(os.path.join(resumed, "1.ckpt"), weights_only=True)
    assert saved["step"] == 4 and saved["scheduler"]["last_epoch"] == 4


def test_checkpoints_follow_the_epoch_10_rule(slim, tmp_path):
    """Over more than 10 epochs only epochs 10 on are saved (train_BC.py:134);
    the schedule halves the rate after 10 epochs."""
    run = _train(tmp_path, "long", "--epoch", "11", "--iterations", "1", "--viz_freq", "1",
                 "--batchsize", "1")
    assert sorted(os.listdir(run)) == ["10.ckpt", "metrics.jsonl", "record.txt"]
    saved = torch.load(os.path.join(run, "10.ckpt"), weights_only=True)
    assert saved["optimizer"]["param_groups"][0]["lr"] == pytest.approx(1e-4 * 0.5)


def test_bf16_with_bf16_refine_layers(slim, tmp_path):
    """--dtype bfloat16 --refine_dtype bfloat16: the checkpoint holds bf16
    refine layers and bf16 moments for them, f32 for everything else; the
    --bridge flags are taken and change nothing."""
    run = _train(tmp_path, "bf16", "--epoch", "1", "--dtype", "bfloat16", "--refine_dtype",
                 "bfloat16", "--bridge", "sync", "--bridge_stride", "1")
    saved = torch.load(os.path.join(run, "0.ckpt"), weights_only=True)
    for k, v in saved["model"].items():
        want = torch.bfloat16 if k.startswith("refine_net.fc_blocks.") else torch.float32
        assert not v.is_floating_point() or v.dtype == want, k
    moments = [s["exp_avg"].dtype for s in saved["optimizer"]["state"].values()]
    assert moments.count(torch.bfloat16) == 4 and torch.float32 in moments
    assert all(math.isfinite(r["loss_regress"]) for r in _lines(run))


def test_test_bc_reads_every_model_path_form(slim, tmp_path):
    """--model_path: a run dir (its latest checkpoint), <run dir>/<epoch>, a
    checkpoint file and a bare state_dict; --debug alone the seed-0 init.
    Each writes one grid of base, traced and refined panels, 3 to a row."""
    run = _train(tmp_path, "r", "--epoch", "1", "--iterations", "1", "--viz_freq", "1")
    sd_path = str(tmp_path / "bc.pt")
    torch.save(SLIM(MP, generator=torch.Generator().manual_seed(3)).state_dict(), sd_path)
    ckpt = torch.load(os.path.join(run, "0.ckpt"), weights_only=True)["model"]
    for i, path in enumerate((run, os.path.join(run, "0"), os.path.join(run, "0.ckpt"), sd_path,
                              None)):
        out = str(tmp_path / f"out{i}")
        args = ["--device", "cpu", "--img_size", str(IMG), "--batchsize", "2", "--max_points",
                str(MP), "--res_output", out]
        written = test_bc.main(args + (["--model_path", path] if path else ["--debug"]))
        assert written == [os.path.join(out, "contours.png")]
        grid = np.asarray(Image.open(written[0]))
        assert grid.shape == (2 * (IMG + 2) + 2, 3 * (IMG + 2) + 2, 3)
    loaded = test_bc.load_model(os.path.join(run, "0"), MP, torch.device("cpu"))
    for k, v in ckpt.items():
        assert torch.equal(loaded.state_dict()[k], v), k
    assert not loaded.training
    with pytest.raises(SystemExit):
        test_bc.main(["--device", "cpu", "--res_output", str(tmp_path / "none")])


def _write_tree(root, n=3):
    rng = np.random.default_rng(0)
    ys, xs = np.mgrid[0:IMG, 0:IMG]
    os.makedirs(os.path.join(root, "1"))
    for i in range(n):
        base = os.path.join(root, "1", f"s{i}")
        Image.fromarray(rng.integers(0, 256, (IMG, IMG, 3), np.uint8)).save(f"{base}.png")
        Image.fromarray(rng.integers(0, 256, (IMG, IMG, 3), np.uint8)).save(f"{base}_edge.png")
        inside = ((xs - 30 - i) / 18.0) ** 2 + ((ys - 32) / 14.0) ** 2 <= 1.0
        for suffix, m in (("_mask", inside), ("_mask_edge", inside & ~np.roll(inside, 2, 0))):
            rgb = np.full((IMG, IMG, 3), 255, np.uint8)
            rgb[m] = (255, 0, 0)
            Image.fromarray(rgb).save(f"{base}{suffix}.png")


def test_folder_data_on_both_clis(slim, tmp_path):
    """--path: train_bc reads a BCDataset tree (3 samples, batch 2: one
    iteration an epoch) on 2 loader threads; test_bc walks it in batches
    of 2."""
    data = str(tmp_path / "data")
    _write_tree(data)
    run = _train(tmp_path, "disk", "--path", data, "--workers", "2", "--epoch", "1",
                 "--viz_freq", "1")
    assert [r["step"] for r in _lines(run)] == [1]
    written = test_bc.main(["--device", "cpu", "--model_path", run, "--path", data,
                            "--img_size", str(IMG), "--batchsize", "2", "--max_points", str(MP),
                            "--res_output", str(tmp_path / "walk")])
    assert [os.path.basename(p) for p in written] == ["contours_0.png", "contours_1.png"]


def test_mesh_and_no_cuda_raise(slim, monkeypatch, tmp_path):
    with pytest.raises(ValueError, match=r"mesh 4x2 != 1 devices: .*torchrun --nproc_per_node 8"):
        _train(tmp_path, "mesh", "--mesh", "4x2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_bc.main(["--debug", "--img_size", str(IMG), "--res_output", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_bc.main(["--img_size", str(IMG), "--iterations", "1",
                       "--res_output", str(tmp_path), "--model_output", str(tmp_path)])


def test_mesh_1x2_runs_the_bridge_with_sharded_weights(slim, tmp_path):
    """--mesh 1x2 over a 2-rank gloo world: FSDP2 shards the weights and
    Adam state over the two model ranks, and the trainer takes the bridge
    (sync, stride 1, the in-forward trace's contours); the first logged
    losses are a one-rank run's, the checkpoint has its keys and shapes,
    and a one-rank --resume reads it; a 1x2 --resume of the one-rank run
    logs the losses of its one-rank resume."""
    args = ["--device", "cpu", "--img_size", str(IMG), "--batchsize", str(BATCH),
            "--max_points", str(MP), "--iterations", "2", "--viz_freq", "1", "--epoch", "1",
            "--res_output", str(tmp_path / "mesh" / "results"),
            "--model_output", str(tmp_path / "mesh" / "logs"),
            "--mesh", "1x2", "--bridge", "sync", "--bridge_stride", "1"]
    runs = W.run_world(W.cli_run, 2, tmp_path, "train_bc", args,
                       {"backbone_layers": (1, 1, 1, 1), "backbone_width": 16})
    assert runs[0] == runs[1]
    one = _train(tmp_path, "one", "--viz_freq", "1", "--epoch", "1")
    mesh_lines, one_lines = _lines(runs[0]), _lines(one)
    assert [r["step"] for r in mesh_lines] == [r["step"] for r in one_lines] == [1, 2]
    for k in train_bc.METRIC_KEYS:
        assert math.isclose(mesh_lines[0][k], one_lines[0][k], rel_tol=1e-5), k
    saved = torch.load(os.path.join(runs[0], "0.ckpt"), weights_only=True)
    want = torch.load(os.path.join(one, "0.ckpt"), weights_only=True)
    assert {k: t.shape for k, t in saved["model"].items()} == {
        k: t.shape for k, t in want["model"].items()}
    assert saved["optimizer"]["state"].keys() == want["optimizer"]["state"].keys()
    resumed = _train(tmp_path, "resumed", "--resume", runs[0], "--epoch", "2")
    assert [r["epoch"] for r in _lines(resumed)] == [1]
    # and a 1x2 mesh resumes the one-rank run: its Adam state sharded alike
    again = _train(tmp_path, "again", "--viz_freq", "1", "--resume", one, "--epoch", "2")
    args[args.index(str(tmp_path / "mesh" / "logs"))] = str(tmp_path / "mesh2" / "logs")
    runs = W.run_world(W.cli_run, 2, tmp_path, "train_bc", args + ["--resume", one, "--epoch", "2"],
                       {"backbone_layers": (1, 1, 1, 1), "backbone_width": 16})
    got, want = _lines(runs[0]), _lines(again)
    assert [r["epoch"] for r in got] == [r["epoch"] for r in want] == [1, 1]
    for k in train_bc.METRIC_KEYS:
        assert math.isclose(got[-1][k], want[-1][k], rel_tol=1e-4), k
