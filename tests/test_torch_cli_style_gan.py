"""The port's Style_GAN trainer CLI (vaeplay_torch.cli.train_style_gan) on the
CPU at 32 px, z 32, batch 4: the run dir, metrics and the whole
StyleGanState checkpointed every epoch, a strict resume with --scan_steps
2 (the JAX CLI's batch seeds), bf16 without label bucketing, the --path
route over a tiny BEGanStyleDataset tree, the JAX CLI's bucketing rule on
device-rendered batches, and the run that raises without a card."""

import json
import math
import os

import numpy as np
import pytest
import torch

from test_torch_be_gan_data import folder  # noqa: F401 (a fixture)
from vaeplay_torch.cli import train_style_gan
from vaeplay_torch.data.be_data import SyntheticBubbleDataset
from vaeplay_torch.train.steps_style_gan import AVG_KEYS
from vaeplay_tpu.train.steps_style_gan import sort_batch_by_label as jax_sort

IMG, Z, BATCH = 32, 32, 4


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _train(tmp_path, name, *extra):
    return train_style_gan.main(["--device", "cpu", "--img_size", str(IMG), "--z_dim", str(Z),
                                 "--batchsize", str(BATCH), "--iterations", "2", "--viz_freq", "2",
                                 "--res_output", str(tmp_path / name / "results"),
                                 "--model_output", str(tmp_path / name / "logs"), *extra])


def _lines(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_writes_run_and_resumes_with_scan_steps(monkeypatch, tmp_path, capsys):
    """One epoch of 2 iterations: <model_output>/Style_GAN/<timestamp>/ with
    record.txt, metrics.jsonl (the seven averaged losses, finite) and
    0.ckpt, the whole StyleGanState (e, g, d). A strict resume with
    --scan_steps 2 trains epoch 1 as one chunk of the JAX CLI's stream
    (batch seeds 100003 and 100004), logs once and writes 1.ckpt in a run dir
    of its own, the three step counts going on; a state of other widths is
    refused."""
    run = _train(tmp_path, "a", "--epochs", "1")
    assert os.path.basename(os.path.dirname(run)) == "Style_GAN"
    assert sorted(os.listdir(run)) == ["0.ckpt", "metrics.jsonl", "record.txt"]
    (line,) = _lines(run)
    assert line["epoch"] == 0 and line["step"] == 2
    assert all(math.isfinite(line[k]) for k in AVG_KEYS)
    with open(os.path.join(run, "record.txt")) as f:
        assert "label_bucketing" in f.read()
    out = capsys.readouterr().out
    assert "rendered on the device" in out and "it 2: g_rec_kl_loss=" in out and "GiB in" in out
    seeds = []
    sample = train_style_gan.sample_bubble_params
    monkeypatch.setattr(train_style_gan, "sample_bubble_params",
                        lambda *a, **kw: seeds.append(kw["batch_seed"]) or sample(*a, **kw))
    resumed = _train(tmp_path, "b", "--epochs", "2", "--resume", run, "--scan_steps", "2")
    assert "resumed epoch 0" in capsys.readouterr().out
    assert seeds == [100003, 100004]
    assert sorted(os.listdir(resumed)) == ["1.ckpt", "metrics.jsonl", "record.txt"]
    assert [(r["epoch"], r["step"]) for r in _lines(resumed)] == [(1, 4)]
    saved = torch.load(os.path.join(resumed, "1.ckpt"), weights_only=True)
    assert sorted(saved) == ["d", "e", "g"]
    for net in ("e", "g", "d"):
        assert saved[net]["step"] == 4
        assert saved[net]["optimizer"]["param_groups"][0]["lr"] == 1e-4
        assert saved[net]["optimizer"]["param_groups"][0]["betas"] == (0.9, 0.999)
    with pytest.raises(RuntimeError, match="size mismatch"):  # strict: a G for another z
        _train(tmp_path, "c", "--epochs", "3", "--resume", resumed, "--z_dim", "16")


def test_bf16_without_bucketing(tmp_path):
    """--dtype bfloat16 --no-label_bucketing trains an epoch with finite
    losses and saves an f32 checkpoint."""
    run = _train(tmp_path, "bf16", "--epochs", "1", "--dtype", "bfloat16",
                 "--no-label_bucketing")
    (line,) = _lines(run)
    assert all(math.isfinite(line[k]) for k in AVG_KEYS)
    saved = torch.load(os.path.join(run, "0.ckpt"), weights_only=True)
    for net in ("e", "g", "d"):
        for k, v in saved[net]["model"].items():
            assert v.dtype == torch.float32, (net, k)


def test_path_over_a_style_tree(folder, tmp_path, capsys):  # noqa: F811
    """--path over BEGanStyleDataset's classes 2 and 3 (3 crops, batch 2:
    one batch an epoch, so the second iteration starts a new pass), on a
    loader thread."""
    run = train_style_gan.main(["--device", "cpu", "--img_size", str(IMG), "--z_dim", str(Z),
                                "--batchsize", "2", "--iterations", "2", "--viz_freq", "1",
                                "--epochs", "1", "--workers", "1", "--path",
                                str(folder / "style"),
                                "--res_output", str(tmp_path / "results"),
                                "--model_output", str(tmp_path / "logs")])
    assert "synthetic" not in capsys.readouterr().out
    lines = _lines(run)
    assert [r["step"] for r in lines] == [1, 2]
    assert all(math.isfinite(r[k]) for r in lines for k in AVG_KEYS)


@pytest.mark.parametrize("enabled", [True, False], ids=["bucketing", "blended"])
def test_rendered_batches_follow_the_jax_bucketing(enabled):
    """device_batches on the synthetic data: each batch is the host batch
    sorted as the JAX CLI sorts it (sort_batch_by_label with pad B / 2),
    x_content the mask on 3 channels, labels % 2, and the split only when
    the bucket is (B/2, B/2) (or never, without bucketing)."""
    ds = SyntheticBubbleDataset(img_size=IMG, data_size=6 * BATCH)
    bucketing = train_style_gan.Bucketing(enabled, 2, BATCH)
    got = list(train_style_gan.device_batches(ds, BATCH, 0, 0, 2, bucketing,
                                              torch.device("cpu")))
    splits = []
    for b, (xt, xc, labels, split) in enumerate(got):
        host = ds.sample_batch(BATCH, batch_seed=b)
        lab = host["labels"] % 2
        if enabled:
            (imgs, bimgs), lab, bucket = jax_sort(lab, host["imgs"], host["bimgs"], pad=BATCH // 2)
            assert split == (bucket if bucket == (2, 2) else None)
        else:
            imgs, bimgs = host["imgs"], host["bimgs"]
            assert split is None
        splits.append(split)
        assert torch.equal(labels, torch.from_numpy(lab))
        assert np.array_equal(xt.permute(0, 2, 3, 1).numpy(), imgs)
        assert np.array_equal(xc.permute(0, 2, 3, 1).numpy(), np.repeat(bimgs, 3, axis=-1))
    assert (None in splits) and ((2, 2) in splits) if enabled else set(splits) == {None}


def test_no_cuda_raises(monkeypatch, tmp_path):
    """Without a card and without --device cpu, the trainer raises instead
    of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_style_gan.main(["--img_size", str(IMG), "--iterations", "1",
                              "--res_output", str(tmp_path), "--model_output", str(tmp_path)])
