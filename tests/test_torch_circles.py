"""The port's circle data (vaeplay_torch.data.circles, ops.geometry's circle
helpers) against the JAX package's: parameter tables, batch order,
rendering, target encoding and decoding for the same seeds, and the disk
dataset's write-and-read round trip."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaeplay_torch.data import circles as TC
from vaeplay_torch.ops import geometry as TG
from vaeplay_tpu.data import circles as JC
from vaeplay_tpu.ops import geometry as JG

N = 64


@pytest.mark.parametrize("seed", [0, 5])
def test_parameter_table_and_batch_order_match_jax(seed):
    port = TC.CircleDataset(n=N, min_radius=8, data_size=50, seed=seed)
    ref = JC.CircleDataset(n=N, min_radius=8, data_size=50, seed=seed)
    np.testing.assert_array_equal(port.params, ref.params)
    assert port.params.dtype == np.float32 and len(port) == 50
    for epoch in (0, 3):
        got, want = list(port.epoch_batches(8, epoch)), list(ref.epoch_batches(8, epoch))
        assert len(got) == len(want) == 6  # 50 // 8, the remainder dropped
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_generate_circle_param_matches_jax():
    got = [TG.generate_circle_param(np.random.default_rng(s), N, 8) for s in range(20)]
    want = [JG.generate_circle_param(np.random.default_rng(s), N, 8) for s in range(20)]
    assert got == want
    for p in got:
        r = p["radius"]
        assert r <= p["x"] <= N - r and r <= p["y"] <= N - r


def test_render_matches_jax_bit_for_bit():
    """Circles with integer and fractional centers and radii, some touching
    the border: the port's NCHW (B, 1, n, n) against the JAX (B, n, n, 1),
    identical, and against the host renderer."""
    rng = np.random.default_rng(1)
    params = np.concatenate([TC.CircleDataset(n=N, min_radius=8, data_size=6, seed=2).params,
                             rng.uniform([3, -4, -4], [30, N + 4, N + 4], (6, 3))]).astype(np.float32)
    r, x, y = (params[:, i] for i in range(3))
    got = TG.render_circle_batch(N, *map(torch.from_numpy, (r, x, y)))
    want = np.asarray(JG.render_circle_batch(N, *map(jnp.asarray, (r, x, y))))
    assert got.shape == (12, 1, N, N) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy()[:, 0], want[..., 0])
    assert set(np.unique(got.numpy())) == {0.0, 1.0}
    for i in range(6):  # integer params: the host renderer's sqrt test agrees
        np.testing.assert_array_equal(got.numpy()[i, 0], TC.render_circle_np(N, x[i], y[i], r[i])[..., 0])
    np.testing.assert_array_equal(TC.render_circle_np(N, 20.5, 31.0, 9.0),
                                  JC.render_circle_np(N, 20.5, 31.0, 9.0))


def test_encode_decode_match_jax():
    params = TC.CircleDataset(n=N, min_radius=8, data_size=16, seed=3).params
    r, x, y = (params[:, i] for i in range(3))
    got = TG.encode_circle_param(N, *map(torch.from_numpy, (r, x, y)))
    want = JG.encode_circle_param(N, *map(jnp.asarray, (r, x, y)))
    for k in ("radius", "x", "y"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(TC.encode_targets(N, params), JC.encode_targets(N, params))
    np.testing.assert_allclose(TC.encode_targets(N, params),
                               np.stack([got["radius"], got["x"], got["y"]], -1),
                               rtol=1e-6, atol=1e-7)
    back = TG.decode_circle_param(N, got["radius"], got["x"], got["y"])
    jback = JG.decode_circle_param(N, want["radius"], want["x"], want["y"])
    for k, raw in zip(("radius", "x", "y"), (r, x, y)):
        np.testing.assert_allclose(back[k].numpy(), np.asarray(jback[k]), rtol=1e-6)
        np.testing.assert_allclose(back[k].numpy(), raw, rtol=1e-5)


@pytest.mark.parametrize("workers", [0, 2])
def test_disk_round_trip(tmp_path, workers):
    """write_circle_dataset's PNGs read back through DiskCircleDataset: the
    params decoded from the names, the images equal to the renders, the
    batches in the JAX package's order; files not named {idx}_{r}_{x}_{y}
    are skipped."""
    ds = TC.CircleDataset(n=N, min_radius=8, data_size=10, seed=4)
    assert TC.write_circle_dataset(str(tmp_path), ds) == 10
    (tmp_path / "notes.txt").write_text("not a circle")
    port = TC.DiskCircleDataset(str(tmp_path), N)
    ref = JC.DiskCircleDataset(str(tmp_path), N)
    assert len(port) == len(ref) == 10
    np.testing.assert_array_equal(port.params, ref.params)
    np.testing.assert_array_equal(np.sort(port.params, axis=0), np.sort(ds.params, axis=0))
    got = list(port.epoch_batches(4, 7, workers))
    want = list(ref.epoch_batches(4, 7, workers=workers))
    assert len(got) == len(want) == 2
    for (gi, gp), (wi, wp) in zip(got, want):
        assert gi.shape == (4, N, N, 1) and gi.dtype == np.float32
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gp, wp)
        for img, (r, x, y) in zip(gi, gp):
            np.testing.assert_array_equal(img, TC.render_circle_np(N, x, y, r))
