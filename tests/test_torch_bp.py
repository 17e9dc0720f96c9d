"""The port's BP slice (vaeplay_torch) against the JAX package's, on the CPU
at f32: the ellipse sampler and point sampler, one attention block, the whole
ComposeNet forward with converted weights, the weight round trip through
vaeplay_tpu's torch_convert, and the synthetic and on-disk data."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from PIL import Image

from vaeplay_torch.core.layers import SelfAttentionBlock as TorchAttentionBlock
from vaeplay_torch.data import bp_data as torch_data
from vaeplay_torch.models import bp as torch_bp
from vaeplay_torch.models.convert import _attnblock, bp_state_dict_from_jax
from vaeplay_torch.ops.geometry import sample_points_ellipse as torch_sample_points
from vaeplay_torch.ops.image import point_sample_ng as torch_point_sample
from vaeplay_tpu.core.layers import SelfAttentionBlock
from vaeplay_tpu.data import bp_data as jax_data
from vaeplay_tpu.models.bp import ComposeNet
from vaeplay_tpu.models.torch_convert import bp_from_torch
from vaeplay_tpu.ops.geometry import sample_points_ellipse
from vaeplay_tpu.ops.image import point_sample_ng
from vaeplay_tpu.utils.jitting import jit_init

SMALL = ((16, 2), (32, 2), (64, 2), (64, 2), (64, 2), (64, 1), (64, 1))  # tests/test_bp.py
TOL = 1e-4  # whole forward at f32: conv and reduction orders differ


def _nonzero_gammas(params, rng):
    """Every attention gamma starts at 0, which would hide the attention
    output; draw each from +-[0.2, 0.6] instead."""
    flat = traverse_util.flatten_dict(params)
    for key in flat:
        if key[-1] == "gamma":
            flat[key] = (rng.uniform(0.2, 0.6, (1,)) * rng.choice([-1, 1])).astype(np.float32)
    return traverse_util.unflatten_dict(flat)


def test_sample_points_ellipse_matches_jax():
    rng = np.random.default_rng(0)
    params = np.concatenate([rng.uniform(-0.3, 0.3, (3, 2)), rng.uniform(0.2, 0.6, (3, 2)),
                             rng.uniform(5, 30, (3, 1))], axis=1).astype(np.float32)
    ref = np.asarray(sample_points_ellipse(jnp.asarray(params), 720, 2))
    got = torch_sample_points(torch.from_numpy(params), 720, 2)
    assert got.dtype == torch.float32 and got.shape == (3, 720, 6)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-6)


def test_point_sample_matches_jax():
    rng = np.random.default_rng(1)
    feat = rng.normal(size=(2, 9, 11, 5)).astype(np.float32)       # NHWC
    grid = rng.uniform(-1.2, 1.2, (2, 50, 2)).astype(np.float32)  # some outside
    ref = np.asarray(point_sample_ng(jnp.asarray(feat), jnp.asarray(grid), False, "bilinear"))
    got = torch_point_sample(torch.from_numpy(feat.transpose(0, 3, 1, 2)),
                             torch.from_numpy(grid), False, "bilinear")
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-6)


def test_self_attention_block_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 64, 1, 720)).astype(np.float32)  # NHWC
    block = SelfAttentionBlock()
    params = _nonzero_gammas(
        jax.device_get(block.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]), rng)
    ref = np.asarray(block.apply({"params": params}, jnp.asarray(x)))
    sd = {}
    _attnblock(sd, "block", params)
    port = TorchAttentionBlock(720)
    port.load_state_dict({k[len("block."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL)


@pytest.fixture(scope="module")
def bp_pair():
    """The JAX ComposeNet at 64 px with SMALL emit channels and nonzero
    gammas, and the port's ComposeNet carrying the converted weights."""
    model = ComposeNet(image_size=64, emit_channels=SMALL)
    variables = jit_init(model, {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)))
    params = _nonzero_gammas(jax.device_get(variables["params"]), np.random.default_rng(4))
    port = torch_bp.ComposeNet(image_size=64, emit_channels=SMALL)
    port.load_state_dict(bp_state_dict_from_jax(params))
    return model, params, port.eval()


def test_compose_net_matches_jax(bp_pair):
    model, params, port = bp_pair
    x = np.random.default_rng(5).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    ref = jax.device_get(jax.jit(lambda p, v: model.apply({"params": p}, v, train=False))(
        params, jnp.asarray(x)))
    # round(step) must not sit at a rounding boundary, where 1e-6 flips it
    frac = np.abs(np.asarray(ref["ellipse_params"])[:, 4] % 1.0 - 0.5)
    assert frac.min() > 1e-3, "test input puts step at x.5; pick another seed"
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert sorted(got) == sorted(ref)
    for name in ref:
        assert tuple(got[name].shape) == ref[name].shape, name
        np.testing.assert_allclose(got[name].numpy(), ref[name], atol=TOL, rtol=TOL,
                                   err_msg=name)


def test_state_dict_round_trips_through_torch_convert(bp_pair):
    """torch_convert.bp_from_torch reads the port's state_dict unchanged and
    gives back the JAX param tree exactly."""
    _, params, port = bp_pair
    back = bp_from_torch({k: v.numpy() for k, v in port.state_dict().items()})
    want, got = traverse_util.flatten_dict(params), traverse_util.flatten_dict(back)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=str(key))


@pytest.mark.parametrize("img_size,batch,batch_seed", [(64, 2, 0), (96, 3, 7)])
def test_synthetic_batches_bit_identical(img_size, batch, batch_seed):
    a = jax_data.SyntheticEmitDataset(img_size=img_size, seed=3).sample_batch(batch, batch_seed)
    b = torch_data.SyntheticEmitDataset(img_size=img_size, seed=3).sample_batch(batch, batch_seed)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_test_split_loader_bit_identical(tmp_path):
    d = tmp_path / "3"
    os.makedirs(d)
    rng = np.random.default_rng(6)
    for name in ("a", "b"):
        gray = rng.integers(0, 256, (40, 30), dtype=np.uint8)
        layer = rng.integers(0, 256, (40, 30, 3), dtype=np.uint8)
        layer[:5] = 255  # white background decodes to black
        Image.fromarray(gray).save(d / f"{name}.png")
        Image.fromarray(gray).save(d / f"{name}_mask2.png")
        Image.fromarray(layer).save(d / f"{name}_layer.png")
    ref = jax_data.BPDatasetTEST(str(tmp_path), 32)
    got = torch_data.BPDatasetTEST(str(tmp_path), 32)
    assert len(got) == len(ref) == 2
    for i in range(2):
        np.testing.assert_array_equal(got.load(i), ref.load(i))
