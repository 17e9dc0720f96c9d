"""The port's BE_GAN models (vaeplay_torch.models.be_gan) against the JAX
package's, on the CPU at a small size: the generator with the (1, 1, 1, 1)
x 16 backbone at 64 px, the discriminator at 256 px (two stages), batch 2.
The weight converters both ways, the forwards in train and eval mode, the
discriminator's shapes and its features (permuted from the JAX model's
NHWC flatten, and the feature-matching distance), and the seeded init."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from vaeplay_torch.models import be_gan as TG
from vaeplay_torch.models.convert import (be_gan_disc_state_dict_from_jax,
                                          be_gan_state_dict_from_jax)
from vaeplay_tpu.models.be_gan import ComposeNet, Discriminator
from vaeplay_tpu.models.torch_convert import be_gan_disc_from_torch, be_gan_from_torch

SLIM, WIDTH, G_IMG, D_IMG, B = (1, 1, 1, 1), 16, 64, 256, 2
TOL = 1e-4  # f32 forward: of each output's largest magnitude, plus relative


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two torch threads a process: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _draw(v, seed):
    """Every collection of `v` with scales, biases, statistics and constants
    drawn, so that an identity or a swapped mapping shows."""
    rng = np.random.default_rng(seed)
    draw = {"scale": (0.5, 1.5), "bias": (-0.2, 0.2), "mean": (-0.5, 0.5), "var": (0.5, 2.0)}
    out = {}
    for col, tree in v.items():
        flat = traverse_util.flatten_dict(tree)
        for k in flat:
            if k[-1] in draw:
                flat[k] = rng.uniform(*draw[k[-1]], flat[k].shape).astype(np.float32)
        out[col] = traverse_util.unflatten_dict(flat)
    return out


@pytest.fixture(scope="module")
def jax_models():
    g = ComposeNet(backbone_layers=SLIM, backbone_width=WIDTH)
    gv = jax.device_get(jax.jit(g.init)({"params": jax.random.PRNGKey(0)},
                                        jnp.zeros((1, G_IMG, G_IMG, 3))))
    d = Discriminator(in_size=D_IMG, num_classes=4)
    m = jnp.zeros((1, D_IMG, D_IMG, 1))
    dv = jax.device_get(jax.jit(d.init)({"params": jax.random.PRNGKey(1)},
                                        jnp.zeros((1, D_IMG, D_IMG, 3)), m, m))
    return g, gv, _draw(gv, 0), d, _draw(dv, 1)


def _ports(jax_models):
    _, _, gv, _, dv = jax_models
    g = TG.ComposeNet(SLIM, WIDTH)
    g.load_state_dict(be_gan_state_dict_from_jax(gv["params"], gv["batch_stats"],
                                                 gv["constants"]))
    d = TG.Discriminator(D_IMG)
    d.load_state_dict(be_gan_disc_state_dict_from_jax(dv["params"], dv["batch_stats"]))
    return g, d


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _flat(tree):
    return traverse_util.flatten_dict(jax.device_get(tree))


def test_converters_round_trip(jax_models):
    """JAX variables -> the port (strict loads) -> its state_dicts -> the JAX
    package's be_gan_from_torch and be_gan_disc_from_torch give the JAX trees
    back exactly; the port's keys are the reference's."""
    _, template, gv, _, dv = jax_models
    g, d = _ports(jax_models)
    g_sd = {k: v.numpy() for k, v in g.state_dict().items()}
    for got, want in zip(be_gan_from_torch(g_sd, template),
                         (gv["params"], gv["batch_stats"], gv["constants"])):
        got, want = _flat(got), _flat(want)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=str(k))
    d_sd = {k: v.numpy() for k, v in d.state_dict().items()}
    for got, want in zip(be_gan_disc_from_torch(d_sd), (dv["params"], dv["batch_stats"])):
        got, want = _flat(got), _flat(want)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=str(k))
    for key in ("backbone.body.conv1.weight", "aux_convs.3.conv.1.running_var",
                "mask_net.conv1.conv.0.conv.0.weight", "edge_net.predictor.2.conv.0.bias"):
        assert key in g_sd, key
    assert not any(k.startswith("feature_net") for k in g_sd)
    assert g_sd["mask_net.conv1.conv.0.conv.0.weight"].shape == (16, 66, 3, 3)  # 64 + 2 coords
    for key, shape in (("content_disc.convs.0.conv.0.weight", (16, 2, 3, 3)),
                       ("boundary_disc.feat_modules.1.1.conv.1.running_mean", (64,)),
                       ("content_disc.pooler.0.conv.0.bias", (64,)),
                       ("predictor.0.fc.0.weight", (128, 128)),
                       ("predictor.2.fc.0.weight", (4, 64))):
        assert d_sd[key].shape == shape, key
    assert "predictor.2.fc.0.bias" not in d_sd


@pytest.mark.parametrize("train", [True, False])
def test_generator_forward_matches_jax(jax_models, train):
    g_model, _, gv, _, _ = jax_models
    x = np.random.default_rng(3).uniform(size=(B, G_IMG, G_IMG, 3)).astype(np.float32)
    fwd = jax.jit(lambda v, x: g_model.apply(v, x, train=train, mutable=["batch_stats"])[0]
                  if train else g_model.apply(v, x, train=False))
    want = fwd(gv, jnp.asarray(x))
    g, _ = _ports(jax_models)
    with torch.no_grad():
        got = g.train(train)(_nchw(x))
    for k in ("edges", "masks"):
        w = np.transpose(np.asarray(want[k]), (0, 3, 1, 2))
        assert got[k].shape == (B, 1, G_IMG, G_IMG)
        np.testing.assert_allclose(got[k].numpy(), w, atol=TOL * np.abs(w).max(), rtol=TOL,
                                   err_msg=k)


def _nhwc_order(feats: torch.Tensor) -> np.ndarray:
    """The port's NCHW-flattened stage features of one MaskMapper pair in the
    JAX model's NHWC order: content stages 0, 1 (64 channels at 32^2, 16^2),
    then boundary's."""
    out, i = [], 0
    for _ in range(2):
        for side in (32, 16):
            n = 64 * side * side
            f = feats[:, i:i + n].reshape(-1, 64, side, side).permute(0, 2, 3, 1)
            out.append(f.reshape(feats.shape[0], -1))
            i += n
    assert i == feats.shape[1]
    return torch.cat(out, dim=1).numpy()


@pytest.mark.parametrize("train", [True, False])
def test_discriminator_matches_jax(jax_models, train):
    """Type logits (B, 4) and features (B, 2 x (64 x 32^2 + 64 x 16^2)): the
    features equal JAX's once put in its NHWC order, and the
    feature-matching distance mean |f(fake) - f(real)| (which does not
    depend on the order) matches."""
    _, _, _, d_model, dv = jax_models
    rng = np.random.default_rng(4)
    x = rng.uniform(size=(B, D_IMG, D_IMG, 3)).astype(np.float32)
    real = [(rng.uniform(size=(B, D_IMG, D_IMG, 1)) < 0.3).astype(np.float32) for _ in range(2)]
    fake = [rng.uniform(size=(B, D_IMG, D_IMG, 1)).astype(np.float32) for _ in range(2)]

    def fwd(v, x, m1, m2):
        if train:
            return d_model.apply(v, x, m1, m2, train=True, mutable=["batch_stats"])[0]
        return d_model.apply(v, x, m1, m2, train=False)

    fwd = jax.jit(fwd)
    _, d = _ports(jax_models)
    d.train(train)
    results = []
    for m1, m2 in (real, fake):
        jt, jf = fwd(dv, *map(jnp.asarray, (x, m1, m2)))
        with torch.no_grad():
            tt, tf = d(_nchw(x), _nchw(m1), _nchw(m2))
        assert tt.shape == (B, 4) and tf.shape == (B, 2 * 64 * (32 * 32 + 16 * 16))
        jt, jf = np.asarray(jt), np.asarray(jf)
        np.testing.assert_allclose(tt.numpy(), jt, atol=TOL * np.abs(jt).max(), rtol=TOL)
        np.testing.assert_allclose(_nhwc_order(tf), jf, atol=TOL * np.abs(jf).max(), rtol=TOL)
        results.append((tf, jf))
    (tr, jr), (tk, jk) = results
    np.testing.assert_allclose(float((tk - tr).abs().mean()), float(np.abs(jk - jr).mean()),
                               rtol=1e-5)


def test_mask_mapper_needs_128_px_and_seeded_init():
    with pytest.raises(ValueError, match="in_size >= 128"):
        TG.MaskMapper(64)
    assert len(TG.MaskMapper(512, 64).feat_modules) == 3
    a = TG.Discriminator(128, generator=torch.Generator().manual_seed(5))
    b = TG.Discriminator(128, generator=torch.Generator().manual_seed(5))
    for (name, t), u in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(t, u), name
    w = a.predictor[0].fc[0].weight.detach()
    assert float(w.abs().max()) <= 1 / 128 ** 0.5  # Kaiming-uniform a = sqrt(5): 1 / sqrt(fan_in)
    assert not a.content_disc.convs[0].conv[0].bias.any()
