"""The port's circle VAE-GAN (vaeplay_torch.models.vae_gan) against the JAX
package's, on the CPU at f32: the training forward with injected noise, the
BatchNorm running statistics it leaves, the eval-mode encoder and decoder,
the weight conversion both ways, and the init's bounds."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from vaeplay_torch.models import vae_gan as TV
from vaeplay_torch.models.convert import vaegan_state_dict_from_jax
from vaeplay_tpu.models.torch_convert import vaegan_from_torch
from vaeplay_tpu.models.vae_gan import VaeGan

IMG, Z, B = 64, 32, 4
LEVELS = int(math.log2(IMG // 8))
TOL = 1e-4


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
    """The JAX VaeGan's init, with every BatchNorm scale, bias and running
    statistic drawn away from 1 and 0 so that a swapped mapping shows."""
    model = VaeGan(img_size=IMG, z_size=Z)
    v = jax.jit(model.init)({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                            jnp.zeros((2, IMG, IMG, 1)))
    rng = np.random.default_rng(0)
    params = traverse_util.flatten_dict(jax.device_get(v["params"]))
    for k in params:
        if k[-2] in ("bn", "fc_bn"):
            params[k] = rng.uniform(0.5, 1.5, params[k].shape).astype(np.float32) \
                if k[-1] == "scale" else rng.uniform(-0.3, 0.3, params[k].shape).astype(np.float32)
    stats = traverse_util.flatten_dict(jax.device_get(v["batch_stats"]))
    for k in stats:
        low, high = (0.5, 2.0) if k[-1] == "var" else (-0.5, 0.5)
        stats[k] = rng.uniform(low, high, stats[k].shape).astype(np.float32)
    return (model, traverse_util.unflatten_dict(params), traverse_util.unflatten_dict(stats),
            jax.device_get(v))


def _port(params, stats) -> TV.VaeGan:
    port = TV.VaeGan(img_size=IMG, z_size=Z)
    port.load_state_dict(vaegan_state_dict_from_jax(params, stats, IMG))
    return port


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(B, IMG, IMG, 1)).astype(np.float32)
    eps, z_p = (rng.normal(size=(B, Z)).astype(np.float32) for _ in range(2))
    return x, eps, z_p


def _nchw(a):
    return np.transpose(np.asarray(a), (0, 3, 1, 2))


def test_training_forward_matches_jax(jax_model):
    """All six outputs of the training forward (batch statistics) with the
    same injected noise; disc_layer is the NHWC flatten on the JAX side."""
    model, params, stats, _ = jax_model
    x, eps, z_p = _inputs(1)
    (j_xt, j_dc, j_dl, j_mu, j_lv, j_p), _ = model.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), train=True,
        noise=(jnp.asarray(eps), jnp.asarray(z_p)), mutable=["batch_stats"])
    port = _port(params, stats).train()
    with torch.no_grad():
        outs = port(torch.from_numpy(_nchw(x).copy()),
                    noise=(torch.from_numpy(eps), torch.from_numpy(z_p)))
    t_xt, t_dc, t_dl, t_mu, t_lv, t_p = (o.numpy() for o in outs)
    c = 32 * 2 ** LEVELS
    j_dl = _nchw(np.asarray(j_dl).reshape(3 * B, 8, 8, c)).reshape(3 * B, -1)
    assert t_xt.shape == (B, 1, IMG, IMG) and t_dc.shape == (3 * B, 1)
    assert t_dl.shape == (3 * B, c * 64) and t_p.shape == (B, 3)
    for name, got, want in (("x_tilde", t_xt, _nchw(j_xt)), ("disc_class", t_dc, j_dc),
                            ("disc_layer", t_dl, j_dl), ("mus", t_mu, j_mu),
                            ("log_variances", t_lv, j_lv), ("params", t_p, j_p)):
        np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL, err_msg=name)


def _updates(key):
    """Running-statistic updates a training forward makes to a BN: the
    decoder runs on z and on z_p, the discriminator's blocks in both the REC
    and the GAN pass (vae_gan.py:229-239); the rest run once."""
    return 2 if key[0] == "decoder" or (key[0] == "discriminator" and key[1] != "fc_bn") else 1


def _batch_size(key):
    """Elements per channel behind one update of the BN at `key`: B (or 3B in
    the discriminator) times the map's H*W for the conv blocks."""
    n = 3 * B if key[0] == "discriminator" else B
    if key[1].startswith("block"):
        i = int(key[1][5:])
        side = {"encoder": IMG // 2 ** (i + 1), "decoder": 16 * 2 ** i,
                "discriminator": IMG // 2 ** i}[key[0]]
        n *= side * side
    return n


def test_running_statistics_match_jax(jax_model):
    """After one training forward: running_mean as JAX's (the same batch
    means, f32 summation order apart: 1e-5); running_var with the batch
    variance's n/(n-1) factor taken out. torch
    (the reference and the port) updates it with the unbiased variance,
    flax with the biased one (ROADMAP queue 3)."""
    model, params, stats, _ = jax_model
    x, eps, z_p = _inputs(2)
    _, mut = model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=True,
                         noise=(jnp.asarray(eps), jnp.asarray(z_p)), mutable=["batch_stats"])
    port = _port(params, stats).train()
    with torch.no_grad():
        port(torch.from_numpy(_nchw(x).copy()), noise=(torch.from_numpy(eps), torch.from_numpy(z_p)))
    got_tree = vaegan_from_torch({k: v.numpy() for k, v in port.state_dict().items()}, IMG)[1]
    got = traverse_util.flatten_dict(got_tree)
    want = traverse_util.flatten_dict(jax.device_get(mut["batch_stats"]))
    old = traverse_util.flatten_dict(stats)
    assert sorted(got) == sorted(want)
    for key in want:
        decay = 0.1 ** _updates(key)  # torch momentum 0.9: new = 0.1 old + 0.9 batch
        if key[-1] == "mean":
            np.testing.assert_allclose(got[key], want[key], atol=1e-5, rtol=1e-5, err_msg=str(key))
            continue
        n = _batch_size(key)
        unbiased = (got[key] - decay * old[key]) * (n - 1) / n
        np.testing.assert_allclose(unbiased, want[key] - decay * old[key], atol=1e-5, rtol=1e-4,
                                   err_msg=str(key))
        if n < 100:  # the BN1d layers: the two conventions differ visibly
            assert not np.allclose(got[key], want[key], rtol=1e-3), key
    for m in port.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            assert m.running_var.dtype == torch.float32


def test_eval_encoder_and_decoder_match_jax(jax_model):
    """Eval mode normalizes with the (perturbed) running statistics."""
    model, params, stats, _ = jax_model
    x, eps, _ = _inputs(3)
    variables = {"params": params, "batch_stats": stats}
    j_mu, j_lv = model.apply(variables, jnp.asarray(x), train=False,
                             method=lambda m, xx, train: m.encoder(xx, train=train))
    j_x = model.apply(variables, jnp.asarray(eps), train=False,
                      method=lambda m, zz, train: m.decoder(zz, train=train))
    port = _port(params, stats).eval()
    with torch.no_grad():
        mu, lv = port.encoder(torch.from_numpy(_nchw(x).copy()))
        xt = port.decoder(torch.from_numpy(eps))
    np.testing.assert_allclose(mu.numpy(), np.asarray(j_mu), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lv.numpy(), np.asarray(j_lv), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(xt.numpy(), _nchw(j_x), atol=TOL, rtol=TOL)


def test_reconstruct_and_generate(jax_model):
    """reconstruct draws its eps from the generator and decodes mu + eps *
    std; generate decodes a prior draw. Both in eval mode."""
    _, params, stats, _ = jax_model
    port = _port(params, stats).eval()
    x = torch.from_numpy(_nchw(_inputs(4)[0]).copy())
    with torch.no_grad():
        xt, p = port.reconstruct(x, torch.Generator().manual_seed(9))
        mu, lv = port.encoder(x)
        z = mu + torch.randn(B, Z, generator=torch.Generator().manual_seed(9)) * torch.exp(0.5 * lv)
        torch.testing.assert_close(xt, port.decoder(z))
        torch.testing.assert_close(p, port.param_encoder(z))
        g = port.generate(3, torch.Generator().manual_seed(2))
    assert g.shape == (3, 1, IMG, IMG) and float(g.min()) >= 0.0 and float(g.max()) <= 1.0


def test_port_state_dict_loads_through_vaegan_from_torch(jax_model):
    """JAX trees -> the port's state_dict -> the JAX package's own
    vaegan_from_torch gives back the same keys and values; the port's keys
    are the reference's."""
    _, params, stats, _ = jax_model
    port = _port(params, stats)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    p2, s2 = vaegan_from_torch(sd, IMG)
    for got, want in ((p2, params), (s2, stats)):
        got, want = traverse_util.flatten_dict(got), traverse_util.flatten_dict(want)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=str(k))
    L = LEVELS
    for key in ("encoder.conv.0.conv.weight", "encoder.fc.1.running_var", "encoder.l_var.bias",
                f"decoder.conv.{L}.0.weight", "decoder.conv.0.bn.weight",
                "discriminator.conv.0.0.bias", f"discriminator.conv.{L}.bn.running_mean",
                "discriminator.fc.3.weight", "param_encoder.xy_fc.1.bias"):
        assert key in sd, key


@pytest.mark.parametrize("name,fan", [
    ("encoder.conv.1.conv", 64 * 25),           # conv: in * kh * kw
    ("decoder.conv.1.conv", (64 * 2 ** (LEVELS - 1) // 2) * 25),  # transpose: out * kh * kw
    ("encoder.l_mu", 1024),                     # linear: in
    ("discriminator.conv.0.0", 25),
])
def test_vaegan_uniform_bounds(jax_model, name, fan):
    """U(+-1/sqrt(3 fan)) on the port's weights, biases zero; the JAX init's
    kernel for the same layer has the same bound."""
    port = TV.VaeGan(img_size=IMG, z_size=Z, generator=torch.Generator().manual_seed(3))
    module = port.get_submodule(name)
    bound = 1.0 / math.sqrt(3.0 * fan)
    w = module.weight.detach().abs()
    assert float(w.max()) <= bound and float(w.max()) > 0.9 * bound
    assert module.bias is None or not module.bias.any()
    jax_keys = {"encoder.conv.1.conv": ("encoder", "block1", "conv", "kernel"),
                "decoder.conv.1.conv": ("decoder", "block1", "conv", "kernel"),
                "encoder.l_mu": ("encoder", "l_mu", "kernel"),
                "discriminator.conv.0.0": ("discriminator", "stem", "kernel")}
    jw = np.abs(traverse_util.flatten_dict(jax_model[3]["params"])[jax_keys[name]])
    assert jw.max() <= bound * (1 + 1e-6) and jw.max() > 0.9 * bound
    again = TV.VaeGan(img_size=IMG, z_size=Z, generator=torch.Generator().manual_seed(3))
    assert torch.equal(again.get_submodule(name).weight, module.weight)  # seeded
