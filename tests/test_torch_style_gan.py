"""The port's Style_GAN nets (vaeplay_torch.models.style_gan) and its SCSE,
transposed-conv and full-resolution head layers against the JAX package's
(vaeplay_tpu.models.style_gan, vaeplay_tpu.core.layers), on the CPU at 32
px, z 32 (the JAX trajectory gate's size), batch 4: E, G (blended, and
label-bucketed on a sorted batch) and D, f64 within 1e-9 of each output's
largest magnitude and f32 within 1e-4 of it plus 1e-4 relative. Weights go
from JAX to the port through models/convert.py, every bias drawn. The
converter round trip runs once at 64 px, z 512 (E to 1024 channels, G's
MLP 512 -> 512 -> 1024 -> 4096). Inputs are noise images: leaky ReLU's
gradient at 0 differs between the frameworks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from vaeplay_torch.core.layers import ConvBlock, SCSEBlock
from vaeplay_torch.models import convert
from vaeplay_torch.models import style_gan as TS
from vaeplay_torch.models.convert import (style_discriminator_state_dict_from_jax,
                                          style_encoder_state_dict_from_jax,
                                          style_generator_state_dict_from_jax)
from vaeplay_tpu.core import layers as JL
from vaeplay_tpu.models import style_gan as JS
from vaeplay_tpu.models.torch_convert import (style_discriminator_from_torch,
                                              style_encoder_from_torch,
                                              style_generator_from_torch)

IMG, Z, B = 32, 32, 4
# f64: each output within 1e-9 of its largest magnitude; f32: 1e-4 of it
# plus 1e-4 relative (summation order, and flax's one-pass E[x^2] - E[x]^2
# instance-norm variance against torch's two-pass one)
TOL = {torch.float64: (1e-9, 0.0), torch.float32: (1e-4, 1e-4)}
LAYER_TOL = 1e-12  # a single f64 layer: of its output's largest magnitude
# (k0 label-0 rows of B_SPLIT, split): the JAX test's cases
# (tests/test_style_gan.py:183-217), k0 from 0 to B_SPLIT
B_SPLIT = 8
SPLITS = [(0, (0, 8)), (3, (4, 8)), (4, (4, 4)), (8, (8, 0)), (5, (8, 8))]


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def randomize(params, seed):
    """Every bias from +-0.2 (they start at 0)."""
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(jax.device_get(params))
    for k, v in flat.items():
        if k[-1] == "bias":
            flat[k] = rng.uniform(-0.2, 0.2, v.shape).astype(np.float32)
    return traverse_util.unflatten_dict(flat)


def init_nets(img=IMG, z=Z, seed=0):
    """The JAX E, G and D (their params randomized, numpy)."""
    e, g, d = (JS.StyleEncoder(z_dim=z, image_size=img), JS.Generator(image_size=img, z_dim=z),
               JS.Discriminator(image_size=img, num_classes=2))
    x = jnp.zeros((1, img, img, 3))
    ev = jax.jit(lambda k: e.init({"params": k}, x))(jax.random.PRNGKey(seed))
    gv = jax.jit(lambda k: g.init({"params": k}, x, jnp.zeros((1, z)), jnp.zeros((1,), jnp.int32)))(
        jax.random.PRNGKey(seed + 1))
    dv = jax.jit(lambda k: d.init({"params": k}, x, x))(jax.random.PRNGKey(seed + 2))
    return (e, g, d), tuple(randomize(v["params"], seed + i) for i, v in enumerate((ev, gv, dv)))


@pytest.fixture(scope="module")
def nets():
    return init_nets()


def port_nets(params, dtype=torch.float32, img=IMG, z=Z):
    """The port's E, G and D with the JAX params, in `dtype`."""
    ep, gp, dp = params
    e, g, d = TS.StyleEncoder(z, img), TS.Generator(img, z), TS.Discriminator(img, 2)
    e.load_state_dict(style_encoder_state_dict_from_jax(ep))
    g.load_state_dict(style_generator_state_dict_from_jax(gp))
    d.load_state_dict(style_discriminator_state_dict_from_jax(dp))
    return e.to(dtype), g.to(dtype), d.to(dtype)


def to_nchw(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2)))).to(dtype)


def jax_apply(model, params, dtype, *args, **kw):
    """model.apply, jitted, in f64 (x64) or f32; float arrays cast, integer
    ones kept; numpy out."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    with jax.enable_x64(dtype == torch.float64):
        cast = lambda t: jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jdt) if np.issubdtype(np.asarray(a).dtype, np.floating)
            else jnp.asarray(a), t)
        fn = jax.jit(lambda p, *a: model.apply({"params": p}, *a, **kw))
        return jax.device_get(fn(cast(params), *cast(args)))


def assert_close(got, want, dtype, what):
    atol, rtol = TOL[dtype]
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=atol * np.abs(want).max(), rtol=rtol, err_msg=what)


def inputs(seed, b=B, img=IMG, z=Z):
    """Noise x_target and x_content (NHWC), a style code, labels sorted
    label-0 first (half each)."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(b, img, img, 3)), rng.uniform(size=(b, img, img, 3)),
            rng.normal(size=(b, z)), np.repeat([0, 1], [b // 2, b - b // 2]).astype(np.int32))


def test_converters_round_trip_at_64px_z512():
    """style_*_from_torch(style_*_state_dict_from_jax(p)) == p bit for bit
    for E, G and D at 64 px, z 512; the keys and shapes are the port's. The
    trees are drawn with numpy on jax.eval_shape's shapes (no compile)."""
    img, z = 64, 512
    rng = np.random.default_rng(0)
    e, g, d = (JS.StyleEncoder(z_dim=z, image_size=img), JS.Generator(image_size=img, z_dim=z),
               JS.Discriminator(image_size=img, num_classes=2))
    x, key = jnp.zeros((1, img, img, 3)), jax.random.PRNGKey(0)
    shapes = (jax.eval_shape(lambda: e.init({"params": key}, x)),
              jax.eval_shape(lambda: g.init({"params": key}, x, jnp.zeros((1, z)),
                                            jnp.zeros((1,), jnp.int32))),
              jax.eval_shape(lambda: d.init({"params": key}, x, x)))
    with torch.device("meta"):
        ports = (TS.StyleEncoder(z, img), TS.Generator(img, z), TS.Discriminator(img, 2))
    convs = ((style_encoder_state_dict_from_jax, lambda sd: style_encoder_from_torch(sd, img)),
             (style_generator_state_dict_from_jax, style_generator_from_torch),
             (style_discriminator_state_dict_from_jax,
              lambda sd: style_discriminator_from_torch(sd, img)))
    for shape, port, (to_port, back) in zip(shapes, ports, convs):
        p = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape, dtype=np.float32),
                                   shape["params"])
        sd = to_port(p)
        assert {k: v.shape for k, v in sd.items()} == {
            k: v.shape for k, v in port.state_dict().items()}
        fa, fb = (traverse_util.flatten_dict(t) for t in (p, back({k: v.numpy()
                                                                  for k, v in sd.items()})))
        assert sorted(fa) == sorted(fb)
        for k in fa:
            assert np.array_equal(fa[k], fb[k]), k
    assert ports[0].convs[-1].conv[0].weight.shape == (1024, 1024, 3, 3)
    assert TS.mlp_widths(512, 64 * 64) == (512, 512, 1024, 4096)
    assert TS.mlp_widths(512, 256 * 256) == (512, 512, 5632, 65536)


def test_parameter_counts_at_256px():
    """E 45.07 M, G 379.98 M (369.16 M of them mlp.model.2, 5632 -> 65536), D
    3.92 M: the JAX init's counts at 256 px, z 512."""
    with torch.device("meta"):
        e, g, d = TS.StyleEncoder(), TS.Generator(), TS.Discriminator()
    count = lambda m: sum(p.numel() for p in m.parameters())
    assert (count(e), count(g), count(d)) == (45_072_128, 379_977_897, 3_924_675)
    assert count(g.mlp.model[2]) == 369_164_288


def test_scse_and_conv_transpose_match_jax():
    """SCSEBlock and the ConvTranspose2d 4/2/1 against JAX's SCSEBlock and
    ConvTransposeBlock in f64, within 1e-12 of the output's largest."""
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, size=(2, 8, 8, 16))
    with jax.enable_x64(True):
        jscse, jup = JL.SCSEBlock(reduction=4), JL.ConvTransposeBlock(
            12, 4, stride=2, padding=1, output_padding=0)
        ps = randomize(jscse.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 2)
        pu = randomize(jup.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"], 3)
        c64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
        want_s = np.asarray(jscse.apply({"params": c64(ps)}, jnp.asarray(x)))
        want_u = np.asarray(jup.apply({"params": c64(pu)}, jnp.asarray(x)))
    scse = SCSEBlock(16, 4)
    sd = {}
    for torch_name, jax_name in (("cSE.1", "cse_reduce"), ("cSE.3", "cse_expand"),
                                 ("sSE.0", "sse")):
        convert._conv_with_bias(sd, torch_name, ps[jax_name])
    scse.load_state_dict(sd)
    up = TS.conv_transpose(16, 12, None)
    sd = {}
    convert._conv_transpose(sd, "0", pu)
    up.load_state_dict({k[2:]: v for k, v in sd.items()})
    xt = to_nchw(x, torch.float64)
    with torch.no_grad():
        got_s = scse.double()(xt).permute(0, 2, 3, 1).numpy()
        got_u = up.double()(xt).permute(0, 2, 3, 1).numpy()
    assert got_u.shape == (2, 16, 16, 12)
    for got, want, what in ((got_s, want_s, "scse"), (got_u, want_u, "conv transpose")):
        np.testing.assert_allclose(got, want, atol=LAYER_TOL * np.abs(want).max(), rtol=0,
                                   err_msg=what)


def test_head_matches_the_space_to_depth_chain():
    """G's full-resolution head, three plain 3x3 ConvBlocks (32, 32, 3, the
    last without activation), against JAX's space_to_depth(2) ->
    SmallChannelConv3x3S1 x 3 -> depth_to_space chain with the same
    canonical kernels, f64 within 1e-12."""
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, size=(2, 16, 16, 32))
    chain = [JL.SmallChannelConv3x3S1(32, block=2), JL.SmallChannelConv3x3S1(32, block=2),
             JL.SmallChannelConv3x3S1(3, block=2, activate=None)]
    with jax.enable_x64(True):
        z = JL.space_to_depth(jnp.asarray(x), 2)
        params = []
        for i, m in enumerate(chain):
            p = randomize(m.init(jax.random.PRNGKey(i), z)["params"], 10 + i)
            p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), p)
            params.append(p)
            z = m.apply({"params": p}, z)
        want = np.asarray(JL.depth_to_space(z, 2))
    head = torch.nn.Sequential(ConvBlock(32, 32, 3), ConvBlock(32, 32, 3),
                               ConvBlock(32, 3, 3, activate=None)).double()
    sd = {}
    for i, p in enumerate(params):
        convert._conv_with_bias(sd, f"{i}.conv.0", jax.device_get(p))
    head.load_state_dict(sd)
    with torch.no_grad():
        got = head(to_nchw(x, torch.float64)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=LAYER_TOL * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_encoder_and_discriminator_match_jax(nets, dtype):
    """E's (mu, logvar) and D's (sigmoid(adv), softmax(aux)); D's outputs are
    f32 or wider and aux sums to 1."""
    (je, _, jd), params = nets
    x_target, x_content, _, _ = inputs(3)
    mu, logvar = jax_apply(je, params[0], dtype, x_target, train=True)
    adv, aux = jax_apply(jd, params[2], dtype, x_target, x_content, train=True)
    e, _, d = port_nets(params, dtype)
    with torch.no_grad():
        got_mu, got_lv = e(to_nchw(x_target, dtype))
        got_adv, got_aux = d(to_nchw(x_target, dtype), to_nchw(x_content, dtype))
    assert got_mu.shape == got_lv.shape == (B, Z) and got_adv.shape == (B, 1)
    assert got_aux.shape == (B, 2) and got_adv.dtype == got_aux.dtype == dtype
    for got, want, what in ((got_mu, mu, "mu"), (got_lv, logvar, "logvar"),
                            (got_adv, adv, "sigmoid(adv)"), (got_aux, aux, "softmax(aux)")):
        assert_close(got.numpy(), want, dtype, what)
    np.testing.assert_allclose(got_aux.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("split", [None, (2, 2)], ids=["blended", "split"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_generator_matches_jax(nets, dtype, split):
    """G's image on a batch sorted label-0 first, blended and at the (2, 2)
    split, against JAX's blended form; in [-1, 1]."""
    (_, jg, _), params = nets
    _, x_content, z, labels = inputs(4)
    want = jax_apply(jg, params[1], dtype, x_content, z, labels, train=True)
    _, g, _ = port_nets(params, dtype)
    with torch.no_grad():
        got = g(to_nchw(x_content, dtype), torch.from_numpy(z).to(dtype),
                torch.from_numpy(labels), split)
    assert got.shape == (B, 3, IMG, IMG) and got.dtype == dtype
    assert float(got.abs().max()) <= 1.0
    assert_close(got.permute(0, 2, 3, 1).numpy(), want, dtype, f"G split={split}")


@pytest.mark.parametrize("k0,split", SPLITS, ids=[f"k0={k}-split={s}" for k, s in SPLITS])
def test_split_generator_equals_blended(nets, k0, split):
    """Label-bucketed MyConv2d (split) equals the blended form on a batch of
    8 sorted label-0 first with k0 zeros: G's output within 1e-12 of its
    largest in f64 and 1e-5 in f32, and in f64 every gradient of sum(G^2)
    within 1e-12 of its tensor's largest (a gated branch the split leaves
    out has the blended form's gradient, 0, exactly)."""
    _, params = nets
    rng = np.random.default_rng(17 + k0)
    xc = rng.uniform(size=(B_SPLIT, IMG, IMG, 3))
    z = rng.normal(size=(B_SPLIT, Z))
    labels = torch.from_numpy(np.repeat([0, 1], [k0, B_SPLIT - k0]))
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        _, g, _ = port_nets(params, dtype)
        outs, grads = [], []
        for form in (None, split):
            g.zero_grad(set_to_none=True)
            out = g(to_nchw(xc, dtype), torch.from_numpy(z).to(dtype), labels, form)
            (out ** 2).sum().backward()
            outs.append(out.detach())
            grads.append({k: (torch.zeros_like(p) if p.grad is None else p.grad)
                          for k, p in g.named_parameters()})
        np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(),
                                   atol=tol * float(outs[0].abs().max()), rtol=0)
        if dtype == torch.float64:
            for k, want in grads[0].items():
                scale = max(float(want.abs().max()), 1e-300)
                np.testing.assert_allclose(grads[1][k].numpy(), want.numpy(),
                                           atol=1e-12 * scale, rtol=0, err_msg=k)
                if (k0 == 0 and ".conv_1." in k) or (k0 == B_SPLIT and ".conv_2." in k):
                    assert not grads[1][k].any() and not want.any(), k


def test_flatten_needs_a_one_by_one_map():
    """E and D flatten 1 x 1 maps only: at a size that leaves a larger map
    the port's models raise instead of flattening in another order than the
    JAX models' NHWC."""
    e, d = TS.StyleEncoder(8, 32), TS.Discriminator(32)
    x = torch.zeros(1, 3, 64, 64)
    with pytest.raises(ValueError, match="not 1 x 1"):
        e(x)
    with pytest.raises(ValueError, match="not 1 x 1"):
        d(x, x)
