"""The port's dataset smoke-check CLI (vaeplay_torch.cli.test_datasets)
against the JAX CLI's grids, pixel for pixel."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from vaeplay_torch.cli import test_datasets
from vaeplay_tpu.cli import test_datasets as jax_test_datasets

IMG, BATCH = 64, 2  # 64 px: the smallest size the circles' min_radius of 10 allows
GRIDS = ("be.png", "bc.png", "bp.png", "bcp.png", "font.png")


def _png(path) -> np.ndarray:
    return np.asarray(Image.open(path)).astype(np.int16)


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    root = tmp_path_factory.mktemp("datasets")
    args = ["--img_size", str(IMG), "--batchsize", str(BATCH)]
    jax_test_datasets.main(["--out", str(root / "jax")] + args)
    out = test_datasets.main(["--out", str(root / "port"), "--device", "cpu"] + args)
    return str(root / "jax"), out


@pytest.mark.parametrize("name", GRIDS)
def test_synthetic_grid_equals_jax(grids, name):
    want, got = (_png(os.path.join(d, name)) for d in grids)
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def test_circle_grid_within_one_grey_level(grids):
    want, got = (_png(os.path.join(d, "circles.png")) for d in grids)
    assert got.shape == want.shape == (IMG + 4, BATCH * (IMG + 2) + 2, 3)
    assert np.abs(got - want).max() <= 1
    assert got.max() == 255  # the circles are drawn


def test_refuses_without_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        test_datasets.main(["--out", str(tmp_path), "--img_size", str(IMG)])
