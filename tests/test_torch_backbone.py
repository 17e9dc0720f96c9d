"""The port's ResNet50-FPN (vaeplay_torch.models.backbone) against the JAX
package's and torchvision's vocabulary, on the CPU: the state_dict keys
against tests/torch_fpn_shim.py, the pyramid's shapes, the forward with
random FrozenBatchNorm constants, the level subsets, the max pool, and the
torchvision-layout checkpoint loader both ways."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from tests import torch_fpn_shim
from vaeplay_torch.models import backbone as TB
from vaeplay_torch.models.convert import backbone_state_dict_from_jax
from vaeplay_torch.ops.image import max_pool
from vaeplay_torch.train.state import freeze_backbone_stem
from vaeplay_tpu.models.backbone import ResNetFPN, convert_torchvision_state_dict
from vaeplay_tpu.ops.image import max_pool as jax_max_pool

SLIM, WIDTH, IMG, B = (1, 1, 1, 1), 16, 64, 2
TOL = 1e-4  # f32 forward: of each output's largest magnitude


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two torch threads a process: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_backbone():
    """The slim JAX ResNetFPN's init, with every FrozenBatchNorm constant
    drawn (scale in [0.5, 1.5], bias and mean in +-0.3, var in [0.5, 2]) and
    the FPN biases drawn, so that an identity or a swapped mapping shows."""
    model = ResNetFPN(layers=SLIM, base_width=WIDTH)
    v = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3))))
    rng = np.random.default_rng(0)
    consts = traverse_util.flatten_dict(v["constants"])
    ranges = {"scale": (0.5, 1.5), "bias": (-0.3, 0.3), "mean": (-0.3, 0.3), "var": (0.5, 2.0)}
    for k in consts:
        consts[k] = rng.uniform(*ranges[k[-1]], consts[k].shape).astype(np.float32)
    params = traverse_util.flatten_dict(v["params"])
    for k in params:
        if k[-1] == "bias":
            params[k] = rng.uniform(-0.1, 0.1, params[k].shape).astype(np.float32)
    return model, traverse_util.unflatten_dict(params), traverse_util.unflatten_dict(consts)


def _port(params, consts) -> TB.ResNetFPN:
    port = TB.ResNetFPN(SLIM, WIDTH)
    port.load_state_dict(backbone_state_dict_from_jax(params, consts))
    return port


def _image(seed, img=IMG):
    return np.random.default_rng(seed).uniform(size=(B, img, img, 3)).astype(np.float32)


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def test_state_dict_keys_match_torchvision_shim():
    """The full-width port has the shim's (torchvision's) keys and shapes,
    and the trainable_layers=3 rule freezes the same tensors as the shim's."""
    port = TB.ResNetFPN()
    shim = torch_fpn_shim.resnet_fpn_backbone("resnet50")
    want = {k: tuple(v.shape) for k, v in shim.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want
    wrapper = torch.nn.Module()
    wrapper.backbone = port
    frozen = {n[len("backbone."):] for n in freeze_backbone_stem(wrapper)}
    assert frozen == {n for n, p in shim.named_parameters() if not p.requires_grad}
    norms = {n for n, m in port.named_modules() if isinstance(m, TB.FrozenBatchNorm2d)}
    assert norms == {n for n, m in shim.named_modules()
                     if isinstance(m, torch_fpn_shim.FrozenBatchNorm2d)}
    assert not any(isinstance(m, torch.nn.modules.batchnorm._NormBase) for m in port.modules())


def test_pyramid_shapes():
    """Strides 4, 8, 16, 32 and the pool's 64, with 256 channels (the JAX
    package's tests/test_be.py::test_backbone_pyramid_shapes)."""
    port = TB.ResNetFPN(SLIM, WIDTH)
    with torch.no_grad():
        outs = port(torch.zeros(1, 3, IMG, IMG))
    assert list(outs) == ["0", "1", "2", "3", "pool"]
    assert {k: tuple(v.shape) for k, v in outs.items()} == {
        "0": (1, 256, 16, 16), "1": (1, 256, 8, 8), "2": (1, 256, 4, 4), "3": (1, 256, 2, 2),
        "pool": (1, 256, 1, 1)}


def test_forward_matches_jax_with_random_frozen_constants(jax_backbone):
    """Every pyramid level within 1e-4 of its largest magnitude."""
    model, params, consts = jax_backbone
    x = _image(1)
    want = jax.jit(model.apply)({"params": params, "constants": consts}, jnp.asarray(x))
    with torch.no_grad():
        got = _port(params, consts)(_nchw(x))
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.transpose(np.asarray(want[k]), (0, 3, 1, 2))
        np.testing.assert_allclose(got[k].numpy(), w, atol=TOL * np.abs(w).max(), rtol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize("levels", [("0",), ("3",), ("pool",), ("1", "pool"), ("0", "2")])
def test_level_subset_equals_full_pyramid(jax_backbone, levels):
    """Asking for some levels gives exactly those, bit for bit as the full
    pyramid computes them, and runs only their 3x3 output convs."""
    _, params, consts = jax_backbone
    port = _port(params, consts)
    ran = []
    for i, conv in enumerate(port.fpn.layer_blocks):
        conv.register_forward_hook(lambda m, a, y, i=i: ran.append(i))
    x = _nchw(_image(2))
    with torch.no_grad():
        full = port(x)
        ran.clear()
        part = port(x, levels=levels)
    assert list(part) == [k for k in TB.LEVELS if k in levels]
    for k in levels:
        assert torch.equal(part[k], full[k]), k
    want = {int(k) for k in levels if k != "pool"} | ({3} if "pool" in levels else set())
    assert sorted(ran) == sorted(want)


@pytest.mark.parametrize("window,stride,padding", [(3, 2, 1), (1, 2, 0)])
def test_max_pool_matches_jax(window, stride, padding):
    """The stem's 3x3 s2 p1 and the FPN pool's 1x1 s2, on negative values
    too (the padding is -inf, not 0)."""
    x = np.random.default_rng(3).normal(size=(2, 9, 10, 5)).astype(np.float32) - 2.0
    want = jax_max_pool(jnp.asarray(x), window, stride, padding)
    got = max_pool(_nchw(x), window, stride, padding)
    np.testing.assert_array_equal(got.numpy(), np.transpose(np.asarray(want), (0, 3, 1, 2)))


def test_frozen_batch_norm_keeps_the_input_dtype():
    """bf16 in, bf16 out (the affine map is formed in f32 and applied in
    bf16, as the JAX step casts the constants), within bf16 rounding of the
    f32 result; f64 in, f64 out."""
    bn = TB.FrozenBatchNorm2d(4)
    g = torch.Generator().manual_seed(0)
    for name in ("weight", "bias", "running_mean"):
        getattr(bn, name).copy_(torch.randn(4, generator=g))
    bn.running_var.copy_(torch.rand(4, generator=g) + 0.5)
    x = torch.randn(2, 4, 3, 3, generator=g)
    ref = (x - bn.running_mean.view(1, -1, 1, 1)) * bn.weight.view(1, -1, 1, 1) / torch.sqrt(
        bn.running_var.view(1, -1, 1, 1) + 1e-5) + bn.bias.view(1, -1, 1, 1)
    torch.testing.assert_close(bn(x), ref, atol=1e-6, rtol=1e-6)
    y = bn(x.bfloat16())
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(y.float(), ref, atol=3e-2, rtol=2e-2)
    assert bn.double()(x.double()).dtype == torch.float64


@pytest.mark.parametrize("form", ["pt", "npz", "detection"])
def test_load_backbone_state_round_trip(tmp_path, jax_backbone, form):
    """A port backbone's state_dict, saved as a .pt, as an .npz, or under a
    detection checkpoint's backbone.body./backbone.fpn. keys inside a
    {"model": ...} wrapper, loads into a fresh backbone exactly, and the JAX
    package's convert_torchvision_state_dict reads the same file into a JAX
    tree whose forward matches the port's."""
    model, params, consts = jax_backbone
    src = _port(params, consts)
    sd = {k: v.clone() for k, v in src.state_dict().items()}
    if form == "npz":
        path = str(tmp_path / "bb.npz")
        np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    elif form == "detection":
        path = str(tmp_path / "bb.pth")
        torch.save({"model": {f"backbone.{k}": v for k, v in sd.items()}}, path)
    else:
        path = str(tmp_path / "bb.pt")
        torch.save(sd, path)
    wrapper = torch.nn.Module()
    wrapper.feature_net = torch.nn.Module()
    wrapper.feature_net.backbone = TB.ResNetFPN(SLIM, WIDTH, generator=torch.Generator().manual_seed(9))
    assert TB.transplant_backbone(path, wrapper) == 1
    for k, v in wrapper.feature_net.backbone.state_dict().items():
        assert torch.equal(v, sd[k]), k

    j_params = traverse_util.unflatten_dict(traverse_util.flatten_dict(params))
    j_consts = traverse_util.unflatten_dict(
        {k: np.ones_like(v) for k, v in traverse_util.flatten_dict(consts).items()})
    convert_torchvision_state_dict(TB.load_backbone_state(path), j_params, j_consts)
    x = _image(4)
    want = jax.jit(model.apply)({"params": j_params, "constants": j_consts}, jnp.asarray(x))["0"]
    with torch.no_grad():
        got = wrapper.feature_net.backbone(_nchw(x), levels=("0",))["0"]
    w = np.transpose(np.asarray(want), (0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), w, atol=TOL * np.abs(w).max(), rtol=TOL)


def test_load_refuses_other_variants(tmp_path):
    """A full-width file into a slim model, a file with fewer blocks than
    the model, and a model with no backbone all raise."""
    full = TB.ResNetFPN()
    path = str(tmp_path / "full.pt")
    torch.save(full.state_dict(), path)
    with pytest.raises(ValueError, match="stem width 64 != model stem width 16"):
        TB.load_torchvision_state(TB.ResNetFPN(SLIM, WIDTH), TB.load_backbone_state(path))
    slim_path = str(tmp_path / "slim.pt")
    torch.save(TB.ResNetFPN(SLIM, 64).state_dict(), slim_path)
    with pytest.raises(ValueError, match=r"no layer1 blocks \[1, 2\]"):
        TB.load_torchvision_state(full, TB.load_backbone_state(slim_path))
    with pytest.raises(ValueError, match="no ResNetFPN"):
        TB.transplant_backbone(slim_path, torch.nn.Linear(2, 2))


def test_seeded_init():
    """Kaiming-uniform convs (bound sqrt(6 / fan_in)), zero FPN biases,
    every FrozenBatchNorm2d at identity, and the same weights for a seed."""
    a = TB.ResNetFPN(SLIM, WIDTH, generator=torch.Generator().manual_seed(5))
    b = TB.ResNetFPN(SLIM, WIDTH, generator=torch.Generator().manual_seed(5))
    for (name, t), u in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(t, u), name
    w = a.body.layer2[0].conv2.weight
    bound = (6.0 / (w.shape[1] * 9)) ** 0.5
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
    assert not a.fpn.inner_blocks[0].bias.any()
    bn = a.body.layer3[0].bn2
    assert bool((bn.weight == 1).all() and (bn.running_var == 1).all())
    assert not bn.bias.any() and not bn.running_mean.any()
    assert not list(bn.parameters())
