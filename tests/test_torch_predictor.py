"""The port's BE serving path on the CPU (the (1, 1, 1, 1) x 16 backbone, 64
px): train/steps_be.py:make_be_eval_step_packed against the thresholded
make_be_eval_step maps and against the JAX package's packed step, and
eval/predictor.py:make_packed_be_predict (uint8 upload, chunking, the
empty batch)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from vaeplay_torch.eval.predictor import make_packed_be_predict
from vaeplay_torch.models import be as TBE
from vaeplay_torch.models.convert import be_state_dict_from_jax
from vaeplay_torch.ops.bits import pack_mask_bits, unpack_mask_bits
from vaeplay_torch.train import steps_be as TS
from vaeplay_tpu.models.be import ComposeNet
from vaeplay_tpu.train.state import TrainState as JaxTrainState
from vaeplay_tpu.train.state import frozen_backbone_adam as jax_frozen_backbone_adam
from vaeplay_tpu.train.steps_be import make_be_eval_step_packed as jax_packed_step

SLIM, WIDTH, IMG, B = (1, 1, 1, 1), 16, 64, 3
NEAR_ZERO = 1e-5  # a JAX logit this close to 0 may fall on either side of the threshold


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two torch threads a process: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_model():
    """The slim JAX ComposeNet with its BatchNorm statistics, conv biases and
    FrozenBatchNorm constants drawn (so that eval mode normalizes by
    statistics that are not identity), and the port holding its weights."""
    model = ComposeNet(backbone_layers=SLIM, backbone_width=WIDTH)
    v = jax.device_get(jax.jit(model.init)({"params": jax.random.PRNGKey(2)},
                                           jnp.zeros((1, IMG, IMG, 3))))
    rng = np.random.default_rng(2)
    draw = {"scale": (0.5, 1.5), "bias": (-0.2, 0.2), "mean": (-0.5, 0.5), "var": (0.5, 2.0)}
    trees = []
    for col in ("params", "batch_stats", "constants"):
        flat = traverse_util.flatten_dict(v[col])
        for k in flat:
            if k[-1] in draw:
                flat[k] = rng.uniform(*draw[k[-1]], flat[k].shape).astype(np.float32)
        trees.append(traverse_util.unflatten_dict(flat))
    params, stats, consts = trees
    port = TBE.ComposeNet(SLIM, WIDTH)
    port.load_state_dict(be_state_dict_from_jax(params, stats, consts))
    return model, params, stats, consts, port.eval()


def _crops(n, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, IMG, IMG, 3), dtype=np.uint8)


def _nchw(crops: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(crops.astype(np.float32) / 255.0).permute(0, 3, 1, 2).contiguous()


def test_packed_step_equals_thresholded_maps(jax_model):
    """The packed bits unpack to the sigmoid maps of make_be_eval_step
    thresholded at 0.5, bit for bit, f32; the model's train mode is
    restored."""
    port = jax_model[-1].train()
    x = _nchw(_crops(B, 1))
    packed = TS.make_be_eval_step_packed(port)(x)
    maps = TS.make_be_eval_step(port)(x)
    assert port.training
    for k in ("edges", "masks"):
        assert packed[k].dtype == torch.uint8 and tuple(packed[k].shape) == (B, IMG, IMG // 8)
        want = (maps[k][:, 0] >= 0.5).numpy().astype(np.float32)
        np.testing.assert_array_equal(unpack_mask_bits(packed[k].numpy(), IMG), want, err_msg=k)
    port.eval()


def test_packed_step_matches_jax(jax_model):
    """Against the JAX package's make_be_eval_step_packed on the same weights
    (carried through be_state_dict_from_jax) and crops: the bits are equal
    except where JAX's logit lies within NEAR_ZERO of 0."""
    model, params, stats, consts, port = jax_model
    crops = _crops(B, 2)
    x = crops.astype(np.float32) / 255.0
    state = JaxTrainState.create(model.apply, params, stats, jax_frozen_backbone_adam(1e-4),
                                 constants=consts)
    want = jax_packed_step(model)(state, jnp.asarray(x))
    logits = jax.jit(lambda v, x: model.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats, "constants": consts}, jnp.asarray(x))
    got = TS.make_be_eval_step_packed(port)(_nchw(crops))
    for k in ("edges", "masks"):
        g = unpack_mask_bits(got[k].numpy(), IMG)
        w = unpack_mask_bits(np.asarray(want[k]), IMG)
        near = np.abs(np.asarray(logits[k])[..., 0]) < NEAR_ZERO
        assert 0.01 < w.mean() < 0.99, (k, w.mean())  # both classes occur
        np.testing.assert_array_equal(g[~near], w[~near], err_msg=k)


def test_predict_uint8_upload_equals_float(jax_model):
    """uint8 crops (divided by 255 on the device) give the bits of the packed
    step on the host's f32 / 255 crops; (B, S, S, 1) f32 {0, 1} on the host,
    and the bytes each way counted."""
    port = jax_model[-1]
    crops = _crops(B, 3)
    predict = make_packed_be_predict(port, IMG)
    a = predict(crops)
    assert predict.copied == {"to_device": crops.nbytes, "from_device": 2 * B * IMG * IMG // 8}
    want = TS.make_be_eval_step_packed(port)(_nchw(crops))
    for k in ("masks", "edges"):
        assert a[k].shape == (B, IMG, IMG, 1) and a[k].dtype == np.float32
        assert set(np.unique(a[k])) <= {0.0, 1.0}
        np.testing.assert_array_equal(pack_mask_bits(torch.from_numpy(a[k][..., 0])).numpy(),
                                      want[k].numpy(), err_msg=k)


def test_predict_rejects_float_crops(jax_model):
    """Crops are uploaded as uint8 only; float crops raise."""
    with pytest.raises(TypeError, match="uint8"):
        make_packed_be_predict(jax_model[-1], IMG)(_crops(1).astype(np.float32) / 255.0)


def test_predict_chunks_large_requests(jax_model):
    """A request above max_batch runs in chunks and equals the one-batch
    result (the model is per sample in eval mode)."""
    port = jax_model[-1]
    crops = _crops(5, 4)
    whole = make_packed_be_predict(port, IMG, max_batch=8)(crops)
    chunked = make_packed_be_predict(port, IMG, max_batch=2)(crops)
    for k in ("masks", "edges"):
        np.testing.assert_array_equal(chunked[k], whole[k], err_msg=k)


def test_predict_empty_batch_raises(jax_model):
    with pytest.raises(ValueError, match="empty batch"):
        make_packed_be_predict(jax_model[-1], IMG)(np.zeros((0, IMG, IMG, 3), np.uint8))
