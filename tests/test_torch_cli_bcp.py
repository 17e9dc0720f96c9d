"""The port's BCP CLIs (vaeplay_torch.cli.train_bcp and test_bcp) on the CPU,
at 64 px and 32 points with a slim G (its encoder towers cut to 2 blocks,
its map-size constant to 16): the run dir, metrics and the whole GanState
checkpointed every epoch, a resume, point attention and bf16, test_bcp on
every --model_path form and over a test tree, and the flags that raise."""

import functools
import json
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

import torch_dist_workers as W
from vaeplay_torch.cli import test_bcp, train_bcp
from vaeplay_torch.models import bcp
from vaeplay_torch.train.steps_bcp import METRIC_KEYS

IMG, BATCH, MP = 64, 2, 32
SLIM = functools.partial(bcp.ComposeNet, encoder_blocks=2, encoder_out_size=16)


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def slim(monkeypatch):
    """The full-width class head (2048 channels) is too heavy for the fast tier."""
    monkeypatch.setattr(train_bcp, "ComposeNet", SLIM)
    monkeypatch.setattr(test_bcp, "ComposeNet", SLIM)


def _train(tmp_path, name, *extra):
    return train_bcp.main(["--device", "cpu", "--img_size", str(IMG), "--batchsize", str(BATCH),
                           "--max_points", str(MP), "--iterations", "2", "--viz_freq", "2",
                           "--res_output", str(tmp_path / name / "results"),
                           "--model_output", str(tmp_path / name / "logs"), *extra])


def _lines(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_writes_run_and_resumes(slim, tmp_path, capsys):
    """One epoch of 2 iterations: <model_output>/BCP/<timestamp>/ with
    record.txt, metrics.jsonl (the eight losses, finite) and 0.ckpt, the
    whole GanState; a resume (strict) for a second epoch writes 1.ckpt in a
    run dir of its own, both nets' step counts going on."""
    run = _train(tmp_path, "a", "--epoch", "1")
    assert os.path.basename(os.path.dirname(run)) == "BCP"
    assert sorted(os.listdir(run)) == ["0.ckpt", "metrics.jsonl", "record.txt"]
    (line,) = _lines(run)
    assert line["epoch"] == 0 and line["step"] == 2
    assert all(math.isfinite(line[k]) for k in METRIC_KEYS)
    with open(os.path.join(run, "record.txt")) as f:
        assert "point_attention" in f.read()
    out = capsys.readouterr().out
    assert "synthetic BCP dataset" in out and "[epoch 0] loss_class=" in out and "GiB in" in out
    resumed = _train(tmp_path, "b", "--epoch", "2", "--resume", run)
    assert "resumed epoch 0" in capsys.readouterr().out
    assert sorted(os.listdir(resumed)) == ["1.ckpt", "metrics.jsonl", "record.txt"]
    assert [r["epoch"] for r in _lines(resumed)] == [1]
    saved = torch.load(os.path.join(resumed, "1.ckpt"), weights_only=True)
    assert sorted(saved) == ["d", "g"] and saved["g"]["step"] == saved["d"]["step"] == 4
    assert saved["d"]["optimizer"]["param_groups"][0]["betas"] == (0.9, 0.999)
    with pytest.raises(RuntimeError, match="Missing key"):  # strict: G without attention
        _train(tmp_path, "c", "--epoch", "3", "--resume", resumed, "--point_attention")


def test_point_attention_and_bf16(slim, tmp_path):
    """--point_attention: G carries line_predictor.batch_attention.{0,1,2};
    with --dtype bfloat16 the losses stay finite and the checkpoint f32.
    test_bcp, which builds G without the attention (as the JAX CLI does),
    refuses that checkpoint (a strict load) rather than drop its blocks."""
    run = _train(tmp_path, "pa", "--epoch", "1", "--point_attention", "--dtype", "bfloat16",
                 "--lr_disc", "1e-4")
    saved = torch.load(os.path.join(run, "0.ckpt"), weights_only=True)
    assert "line_predictor.batch_attention.2.gamma" in saved["g"]["model"]
    for net in ("g", "d"):
        for k, v in saved[net]["model"].items():
            assert v.dtype == torch.float32, k
    assert saved["d"]["optimizer"]["param_groups"][0]["lr"] == 1e-4
    assert all(math.isfinite(r[k]) for r in _lines(run) for k in METRIC_KEYS)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        test_bcp.main(["--device", "cpu", "--model_path", run, "--img_size", str(IMG),
                       "--max_points", str(MP), "--res_output", str(tmp_path / "pa_out")])


def test_test_bcp_reads_every_model_path_form(slim, tmp_path):
    """--model_path: a run dir (its latest checkpoint), <run dir>/<epoch>, a
    checkpoint file (its `g`) and a bare state_dict; --debug alone the
    seed-0 init. Each writes one grid of base, contour and predicted
    panels, 3 to a row."""
    run = _train(tmp_path, "r", "--epoch", "1", "--iterations", "1", "--viz_freq", "1")
    sd_path = str(tmp_path / "bcp.pt")
    torch.save(SLIM(MP, generator=torch.Generator().manual_seed(3)).state_dict(), sd_path)
    for i, path in enumerate((run, os.path.join(run, "0"), os.path.join(run, "0.ckpt"), sd_path,
                              None)):
        out = str(tmp_path / f"out{i}")
        args = ["--device", "cpu", "--img_size", str(IMG), "--batchsize", "2", "--max_points",
                str(MP), "--res_output", out]
        written = test_bcp.main(args + (["--model_path", path] if path else ["--debug"]))
        assert written == [os.path.join(out, "points.png")]
        grid = np.asarray(Image.open(written[0]))
        assert grid.shape == (2 * (IMG + 2) + 2, 3 * (IMG + 2) + 2, 3)
    ckpt = torch.load(os.path.join(run, "0.ckpt"), weights_only=True)["g"]["model"]
    loaded = test_bcp.load_model(os.path.join(run, "0"), MP, torch.device("cpu"))
    for k, v in ckpt.items():
        assert torch.equal(loaded.state_dict()[k], v), k
    assert not loaded.training
    with pytest.raises(SystemExit):
        test_bcp.main(["--device", "cpu", "--res_output", str(tmp_path / "none")])


def test_predict_traces_channel_1_before_the_forward(slim):
    """predict: the contours of channel 1, traced on the host at level 0.8
    (eval_contours_from_masks), are the ones the forward reads."""
    model = test_bcp.load_model(None, MP, torch.device("cpu"))
    imgs = np.zeros((2, IMG, IMG, 3), np.float32)
    imgs[0, 20:40, 15:45, 1] = 1.0
    preds = test_bcp.predict(model, imgs, torch.device("cpu"))
    pts, counts = bcp.eval_contours_from_masks(imgs, MP)
    assert torch.equal(preds["contours"], torch.from_numpy(pts))
    assert preds["contour_counts"].tolist() == counts.tolist() and counts[0] > 0 == counts[1]


def _write_train_tree(root):
    """BCPDataset's `<class>/{layers,masks,annotations}`: 3 samples."""
    rng = np.random.default_rng(0)
    ys, xs = np.mgrid[0:IMG, 0:IMG]
    for i in range(3):
        d = os.path.join(root, str(1 + i % 2))
        for sub in ("layers", "masks", "annotations"):
            os.makedirs(os.path.join(d, sub), exist_ok=True)
        inside = ((xs - 30 - i) / 18.0) ** 2 + ((ys - 32) / 14.0) ** 2 <= 1.0
        layer = np.full((IMG, IMG, 3), 255, np.uint8)
        layer[inside] = (255, 0, 0)
        Image.fromarray(layer).save(os.path.join(d, "layers", f"s{i}.png"))
        Image.fromarray((inside * 255).astype(np.uint8)).save(os.path.join(d, "masks", f"s{i}.png"))
        t = rng.uniform(0, 2 * np.pi, 40)
        pts = np.stack([30 + i + 18 * np.cos(t), 32 + 14 * np.sin(t), 30 + i + 24 * np.cos(t),
                        32 + 20 * np.sin(t), rng.uniform(size=40) < 0.3,
                        rng.uniform(size=40) < 0.1], axis=-1)
        with open(os.path.join(d, "annotations", f"s{i}.txt"), "w") as f:
            json.dump({"points": pts.tolist()}, f)


def _write_test_tree(root, n=3):
    """BCPDatasetTEST's class dirs 2 and 3: `<name>.png`, `_mask2`, `_layer`."""
    rng = np.random.default_rng(1)
    ys, xs = np.mgrid[0:IMG, 0:IMG]
    for i in range(n):
        d = os.path.join(root, "2" if i % 2 else "3")
        os.makedirs(d, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (IMG, IMG, 3), np.uint8)).save(
            os.path.join(d, f"p{i}.png"))
        inside = ((xs - 30) / 18.0) ** 2 + ((ys - 32 - i) / 14.0) ** 2 <= 1.0
        Image.fromarray((inside * 255).astype(np.uint8)).save(os.path.join(d, f"p{i}_mask2.png"))
        layer = np.full((IMG, IMG, 3), 255, np.uint8)
        layer[inside] = (255, 0, 0)
        Image.fromarray(layer).save(os.path.join(d, f"p{i}_layer.png"))


def test_folder_data_on_both_clis(slim, tmp_path):
    """--path: train_bcp reads a BCPDataset tree (3 samples, batch 2: the
    epoch's second iteration starts the data over) on 2 loader threads;
    test_bcp walks a class-2/3 test tree in batches of 2."""
    data = str(tmp_path / "data")
    _write_train_tree(data)
    run = _train(tmp_path, "disk", "--path", data, "--workers", "2", "--epoch", "1")
    assert [r["step"] for r in _lines(run)] == [2]
    test_data = str(tmp_path / "test_data")
    _write_test_tree(test_data)
    written = test_bcp.main(["--device", "cpu", "--model_path", run, "--path", test_data,
                             "--img_size", str(IMG), "--batchsize", "2", "--max_points", str(MP),
                             "--res_output", str(tmp_path / "walk")])
    assert [os.path.basename(p) for p in written] == ["points_0.png", "points_1.png"]


def test_mesh_and_no_cuda_raise(slim, monkeypatch, tmp_path):
    with pytest.raises(ValueError, match=r"mesh 4x2 != 1 devices: .*torchrun --nproc_per_node 8"):
        _train(tmp_path, "mesh", "--mesh", "4x2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_bcp.main(["--debug", "--img_size", str(IMG), "--res_output", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_bcp.main(["--img_size", str(IMG), "--iterations", "1",
                        "--res_output", str(tmp_path), "--model_output", str(tmp_path)])


def test_mesh_1x2_point_attention_rings(slim, tmp_path):
    """--mesh 1x2 --point_attention over a 2-rank gloo world: the point
    attention runs as a ring over the two model ranks (max_points divides
    by 2), and the first logged losses are a one-rank run's; the
    checkpoint has its keys and shapes."""
    args = ["--device", "cpu", "--img_size", str(IMG), "--batchsize", str(BATCH),
            "--max_points", str(MP), "--iterations", "2", "--viz_freq", "1",
            "--res_output", str(tmp_path / "mesh" / "results"),
            "--model_output", str(tmp_path / "mesh" / "logs"),
            "--mesh", "1x2", "--point_attention"]
    runs = W.run_world(W.cli_run, 2, tmp_path, "train_bcp", args,
                       {"encoder_blocks": 2, "encoder_out_size": 16})
    assert runs[0] == runs[1]
    one = _train(tmp_path, "one", "--viz_freq", "1", "--point_attention")
    mesh_lines, one_lines = _lines(runs[0]), _lines(one)
    assert [r["step"] for r in mesh_lines] == [r["step"] for r in one_lines] == [1, 2]
    for k in train_bcp.METRIC_KEYS:
        assert math.isclose(mesh_lines[0][k], one_lines[0][k], rel_tol=1e-5, abs_tol=1e-7), k
    saved = torch.load(os.path.join(runs[0], "0.ckpt"), weights_only=True)
    want = torch.load(os.path.join(one, "0.ckpt"), weights_only=True)
    for net in ("g", "d"):
        assert {k: t.shape for k, t in saved[net]["model"].items()} == {
            k: t.shape for k, t in want[net]["model"].items()}


def test_ring_routing_rule(capsys):
    """The JAX trainer's rule: a ring only with --point_attention on M > 1
    model ranks and max_points divisible by M, with min_n = min(1024,
    max_points); otherwise None, said so when M > 1."""
    assert train_bcp.ring_routing(None, 2048, True) is None

    class Mesh:  # a 1 x 3 mesh's face, as RingRouting reads it
        mesh_dim_names = ("data", "model")

        @staticmethod
        def size(dim):
            return (1, 3)[dim]

    assert train_bcp.ring_routing(Mesh, 2048, False) is None
    assert train_bcp.ring_routing(Mesh, 2048, True) is None
    assert "NOT active" in capsys.readouterr().out
    ring = train_bcp.ring_routing(Mesh, 96, True)
    assert ring is not None and ring.min_n == 96 and ring.active(96)
