"""The port's BE data (vaeplay_torch.data.be_data) against the JAX package's
data/be_data.py, on the CPU: the synthetic bubble batches and parameter
tables for a seed, the rasteriser against the JAX package's numpy host
render bit for bit, and the reference's folder layout."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vaeplay_torch.data import be_data as TD
from vaeplay_tpu.data import be_data as JD


@pytest.mark.parametrize("img,seed,batch_seed", [(64, 0, 0), (48, 3, 17), (128, 7, 20003)])
def test_synthetic_batches_match_jax(img, seed, batch_seed):
    """The same images, masks and labels, bit for bit, and the same epoch."""
    want = JD.SyntheticBubbleDataset(img_size=img, seed=seed).sample_batch(3, batch_seed)
    got = TD.SyntheticBubbleDataset(img_size=img, seed=seed).sample_batch(3, batch_seed)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    j_epoch = list(JD.SyntheticBubbleDataset(img_size=img, data_size=8, seed=seed).epoch_batches(4, 2))
    t_epoch = list(TD.SyntheticBubbleDataset(img_size=img, data_size=8, seed=seed).epoch_batches(4, 2))
    assert len(t_epoch) == len(j_epoch) == 2
    for a, b in zip(t_epoch, j_epoch):
        np.testing.assert_array_equal(a["imgs"], b["imgs"])


def test_sample_bubble_params_match_jax():
    """The port keeps the table in f64 (the JAX package's is the same values
    rounded to f32), with the same labels."""
    want, want_l = JD.sample_bubble_params(64, 5, seed=3, batch_seed=9)
    got, got_l = TD.sample_bubble_params(64, 5, seed=3, batch_seed=9)
    assert got.dtype == np.float64 and got.shape == (5, 5)
    np.testing.assert_array_equal(got.astype(np.float32), want)
    np.testing.assert_array_equal(got_l, want_l)


@pytest.mark.parametrize("img,seed,batch_seed", [(64, 3, 17), (96, 0, 1), (512, 1, 2)])
def test_render_equals_jax_host_render(img, seed, batch_seed):
    """render_bubble_batch on a table equals the JAX package's numpy host
    batch bit for bit (the same f64 distance test), NCHW, where the JAX
    package's f32 device render may differ on boundary pixels
    (tests/test_be.py::test_device_bubble_render_matches_host)."""
    host = JD.SyntheticBubbleDataset(img_size=img, seed=seed).sample_batch(2, batch_seed)
    table, labels = TD.sample_bubble_params(img, 2, seed=seed, batch_seed=batch_seed)
    imgs, bimgs, eimgs = TD.render_bubble_batch(img, torch.from_numpy(table))
    np.testing.assert_array_equal(labels, host["labels"])
    for got, want in ((imgs, host["imgs"]), (bimgs, host["bimgs"]), (eimgs, host["eimgs"])):
        assert got.dtype == torch.float32 and got.is_contiguous()
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    j_imgs, j_b, _ = JD.render_bubble_batch(img, jnp.asarray(table.astype(np.float32)))
    assert (np.asarray(j_b) != host["bimgs"]).mean() < 2e-3


def test_epoch_params_render_to_epoch_batches():
    """SyntheticBubbleDataset.epoch_params, rendered, is epoch_batches."""
    ds = TD.SyntheticBubbleDataset(img_size=32, data_size=6, seed=2)
    tables = list(ds.epoch_params(3, seed=4))
    batches = list(ds.epoch_batches(3, seed=4))
    assert len(tables) == len(batches) == 2
    for (table, labels), batch in zip(tables, batches):
        np.testing.assert_array_equal(labels, batch["labels"])
        imgs = TD.render_bubble_batch(32, torch.from_numpy(table))[0]
        np.testing.assert_array_equal(imgs.permute(0, 2, 3, 1).numpy(), batch["imgs"])


def _write_folder(root, names_by_class, size=20):
    rng = np.random.default_rng(0)
    for cls, names in names_by_class.items():
        d = os.path.join(root, cls)
        os.makedirs(d)
        for name in names:
            img = rng.integers(0, 256, (size + 3, size + 5, 3), dtype=np.uint8)
            Image.fromarray(img).save(os.path.join(d, f"{name}.png"))
            layer = np.full((size + 3, size + 5, 3), 255, np.uint8)
            layer[2:8, 3:9] = (255, 0, 0)
            layer[9:12, 3:9] = (0, 255, 0)
            Image.fromarray(layer).save(os.path.join(d, f"{name}_layer.png"))


@pytest.mark.parametrize("workers", [0, 2])
def test_be_dataset_folders_match_jax(tmp_path, workers):
    """Classes {1,2,3} for training (the `_layer` files skipped as samples,
    decoded into content and edge masks), "test" for testing; the same
    samples, resizes and seeded batch order as the JAX package's loader,
    with or without loader threads."""
    root = str(tmp_path / "data")
    _write_folder(root, {"1": ["a", "b"], "2": ["c"], "3": ["d", "e"], "test": ["f", "g", "h"],
                         "9": ["z"]})
    got = TD.BEDataset(root, (16, 12))
    want = JD.BEDataset(root, (16, 12))
    assert got.imgs == want.imgs and got.masks == want.masks and got.labels == [1, 1, 2, 3, 3]
    g_batches = list(got.epoch_batches(2, seed=5, workers=workers))
    w_batches = list(want.epoch_batches(2, seed=5))
    assert len(g_batches) == len(w_batches) == 2
    for a, b in zip(g_batches, w_batches):
        for k in ("imgs", "bimgs", "eimgs", "labels"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert g_batches[0]["imgs"].shape == (2, 12, 16, 3)
    assert g_batches[0]["bimgs"].max() == 1.0 and g_batches[0]["eimgs"].max() == 1.0
    test = TD.BEDataset(root, (16, 12), if_test=True)
    assert len(test) == 3 and test.masks == [] and test.load(0)[1] is None
    np.testing.assert_array_equal(test.load(2)[0], JD.BEDataset(root, (16, 12), True).load(2)[0])
