"""The port's BE_font nets (vaeplay_torch.models.be_font) against the JAX
package's (vaeplay_tpu.models.be_font), on the CPU at 32 px (the JAX fast
tier's size), batch 2: G slim (max_channel 64, so the relay FCs are 1024
wide), D at its fixed widths (fc0 (1024 + 512) -> 512 at 32 px). Weights
go from JAX to the port through models/convert.py; every bias, attention
gamma and BatchNorm buffer is drawn, so each attention block and the eval
path carry signal. The converter round trip runs once at full width.

Each attention block sees one position, where the JAX package computes its
plain `_reference_attention` (its Pallas kernel starts at N = 64); the port
on the CPU computes its plain version too. In f64 the JAX attention is
replaced by an f64 einsum (the plain one keeps f32 scores)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from test_torch_train_be_gan import BiasedRunningVar
from vaeplay_torch.core.layers import SelfAttentionBlock
from vaeplay_torch.models import be_font as TF
from vaeplay_torch.models.convert import (be_font_disc_state_dict_from_jax,
                                          be_font_state_dict_from_jax)
from vaeplay_tpu.core import layers as JL
from vaeplay_tpu.models import be_font as JF
from vaeplay_tpu.models.torch_convert import be_font_disc_from_torch, be_font_from_torch

IMG, B, MAXC = 32, 2, 64
# f64: each output within 1e-9 of its largest magnitude; f32: 1e-4 of it
# plus 1e-4 relative (summation order and flax's one-pass E[x^2] - E[x]^2
# instance-norm variance against torch's two-pass one)
TOL = {torch.float64: (1e-9, 0.0), torch.float32: (1e-4, 1e-4)}


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def randomize(variables, seed):
    """Every bias and BatchNorm scale/bias from +-0.2 (scales 1 +- 0.2), every
    attention gamma from +-[0.2, 0.6], running means from +-0.1 and running
    variances from [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    out = {}
    for col, tree in jax.device_get(variables).items():
        flat = traverse_util.flatten_dict(tree)
        for k, v in flat.items():
            if k[-1] == "gamma":
                flat[k] = (rng.choice([-1.0, 1.0]) * rng.uniform(0.2, 0.6, (1,))).astype(np.float32)
            elif k[-1] in ("bias", "mean"):
                flat[k] = rng.uniform(-0.2 if k[-1] == "bias" else -0.1,
                                      0.2 if k[-1] == "bias" else 0.1, v.shape).astype(np.float32)
            elif k[-1] == "scale":
                flat[k] = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
            elif k[-1] == "var":
                flat[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        out[col] = traverse_util.unflatten_dict(flat)
    return out


def init_nets(img=IMG, max_channel=MAXC, seed=0):
    """The JAX G (both branches, init_all) and D, their variables randomized."""
    g, d = JF.ComposeNet(in_size=img, max_channel=max_channel), JF.Discriminator(in_size=img)
    y = {"cls": jnp.zeros((1, 143)), "cnt_style": jnp.zeros((1, 5))}
    gv = jax.jit(lambda k: g.init({"params": k}, jnp.zeros((1, img, img, 3)), y,
                                  method=g.init_all))(jax.random.PRNGKey(seed))
    dv = jax.jit(lambda k: d.init({"params": k}, jnp.zeros((1, img, img, 2)), y))(
        jax.random.PRNGKey(seed + 1))
    return g, d, randomize(gv, seed), randomize(dv, seed + 1)


@pytest.fixture(scope="module")
def nets():
    return init_nets()


def port_g(gv, dtype=torch.float32, img=IMG, max_channel=MAXC):
    g = TF.ComposeNet(img, max_channel=max_channel)
    g.load_state_dict(be_font_state_dict_from_jax(gv["params"], gv["batch_stats"]))
    return g.to(dtype)


def port_d(dv, dtype=torch.float32, img=IMG):
    d = TF.Discriminator(img)
    d.load_state_dict(be_font_disc_state_dict_from_jax(dv["params"], dv["batch_stats"]))
    return d.to(dtype)


def f64_attention(q, k, v, ring=None):
    return jnp.einsum("bnm,bmc->bnc", jax.nn.softmax(jnp.einsum("bnd,bmd->bnm", q, k), -1), v)


def inputs(seed, b=B, img=IMG):
    """Noise images and [mask, edge] maps (NHWC), labels and style vectors."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(b, img, img, 3)), rng.uniform(size=(b, img, img, 2)),
            rng.integers(0, 143, b), rng.normal(size=(b, 5)))


def to_nchw(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2)))).to(dtype)


def cond_torch(labels, styles, dtype):
    return {"cls": torch.nn.functional.one_hot(torch.from_numpy(labels), 143).to(dtype),
            "cnt_style": torch.from_numpy(styles).to(dtype)}


def cond_jax(labels, styles, jdt):
    return {"cls": jax.nn.one_hot(jnp.asarray(labels), 143, dtype=jdt),
            "cnt_style": jnp.asarray(styles, jdt)}


def jax_apply(model, variables, dtype, *args, train):
    """model.apply in f64 (x64, f64 attention) or f32; returns (outputs,
    updated batch_stats) as numpy."""
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    with jax.enable_x64(dtype == torch.float64):
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jdt), t)
        out, mut = model.apply(cast(variables), *cast(args), train=train, mutable=["batch_stats"])
        return jax.device_get(out), jax.device_get(mut["batch_stats"])


def assert_close(got, want, dtype, what):
    atol, rtol = TOL[dtype]
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=atol * np.abs(want).max(), rtol=rtol, err_msg=what)


def test_converters_round_trip_at_full_width():
    """be_font_from_torch(be_font_state_dict_from_jax(p, s), 32) == (p, s)
    bit for bit at full width (64 -> 512 channels, the relay FCs 8704 ->
    8192 -> 8192), and the same for D; the keys and shapes are the port's.
    The trees are drawn with numpy on jax.eval_shape's shapes (no compile)."""
    rng = np.random.default_rng(0)
    y = {"cls": jnp.zeros((1, 143)), "cnt_style": jnp.zeros((1, 5))}
    g, d = JF.ComposeNet(in_size=IMG), JF.Discriminator(in_size=IMG)
    shapes = {"g": jax.eval_shape(lambda: g.init({"params": jax.random.PRNGKey(0)},
                                                 jnp.zeros((1, IMG, IMG, 3)), y,
                                                 method=g.init_all)),
              "d": jax.eval_shape(lambda: d.init({"params": jax.random.PRNGKey(0)},
                                                 jnp.zeros((1, IMG, IMG, 2)), y))}
    draw = lambda t: jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape, dtype=np.float32), t)
    with torch.device("meta"):
        ports = {"g": TF.ComposeNet(IMG), "d": TF.Discriminator(IMG)}
    for net, to_port, back in (("g", be_font_state_dict_from_jax, be_font_from_torch),
                               ("d", be_font_disc_state_dict_from_jax, be_font_disc_from_torch)):
        p, s = draw(shapes[net]["params"]), draw(shapes[net]["batch_stats"])
        sd = to_port(p, s)
        want = {k: v.shape for k, v in ports[net].state_dict().items()}
        assert {k: v.shape for k, v in sd.items()} == want
        p2, s2 = back({k: v.numpy() for k, v in sd.items()}, IMG)
        for a, b in ((p, p2), (s, s2)):
            fa, fb = traverse_util.flatten_dict(a), traverse_util.flatten_dict(b)
            assert sorted(fa) == sorted(fb)
            for k in fa:
                assert np.array_equal(fa[k], fb[k]), (net, k)


def test_parameter_counts_at_64px():
    """G 167.37 M parameters (the relay FC pair 138.4 M of them), D 37.62 M,
    the style encoder 2.05 M: the JAX init's counts at 64 px."""
    with torch.device("meta"):
        g, d = TF.ComposeNet(64), TF.Discriminator(64)
    count = lambda m: sum(p.numel() for p in m.parameters())
    assert count(g) == 167_368_264 and count(d) == 37_617_820
    assert count(g.style_encoder) == 2_051_456 and count(g.relay_convs) == 138_428_416


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("use_y", [True, False], ids=["labels", "self_encoded"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_generator_matches_jax(nets, monkeypatch, dtype, use_y, train):
    """masks and edges of both conditioning paths in train and eval mode; in
    train mode also the BatchNorm running statistics after the forward
    (means as they are, variances with torch's n / (n - 1) taken out), in
    eval mode every buffer unchanged."""
    g, _, gv, _ = nets
    if dtype == torch.float64:
        monkeypatch.setattr(JL, "spatial_self_attention", f64_attention)
    imgs, _, labels, styles = inputs(1)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    with jax.enable_x64(dtype == torch.float64):
        y = cond_jax(labels, styles, jdt) if use_y else None
    want, want_bs = jax_apply(g, gv, dtype, imgs, y, train=train)
    model = port_g(gv, dtype).train(train)
    tracker = BiasedRunningVar(model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        got = model(to_nchw(imgs, dtype), cond_torch(labels, styles, dtype) if use_y else None)
    for k in ("masks", "edges"):
        assert got[k].shape == (B, 1, IMG, IMG) and got[k].dtype == dtype
        assert_close(got[k].permute(0, 2, 3, 1).numpy(), want[k], dtype, k)
    after = tracker.state_dict(model)
    for k, w in be_font_state_dict_from_jax(gv["params"], want_bs).items():
        if not train:
            assert np.array_equal(after[k], before[k].numpy()), k
        elif k.endswith(("running_mean", "running_var")):
            assert_close(after[k], w.numpy(), dtype, k)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_discriminator_matches_jax(nets, monkeypatch, dtype):
    """sigmoid(adv) and the aux logits in train mode, and the running
    statistics after the forward; sigmoid(adv) stays f32 or wider."""
    _, d, _, dv = nets
    if dtype == torch.float64:
        monkeypatch.setattr(JL, "spatial_self_attention", f64_attention)
    _, maps, labels, styles = inputs(2)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    with jax.enable_x64(dtype == torch.float64):
        y = cond_jax(labels, styles, jdt)
    (adv, aux), want_bs = jax_apply(d, dv, dtype, maps, y, train=True)
    model = port_d(dv, dtype).train()
    tracker = BiasedRunningVar(model)
    with torch.no_grad():
        got_adv, got_aux = model(to_nchw(maps, dtype), cond_torch(labels, styles, dtype))
    assert got_adv.shape == (B, 1) and got_aux.shape == (B, 143) and got_adv.dtype == dtype
    assert_close(got_adv.numpy(), adv, dtype, "sigmoid(adv)")
    assert_close(got_aux.numpy(), aux, dtype, "aux")
    after = tracker.state_dict(model)
    for k, w in be_font_disc_state_dict_from_jax(dv["params"], want_bs).items():
        if k.endswith(("running_mean", "running_var")):
            assert_close(after[k], w.numpy(), dtype, k)


def test_attention_block_at_one_position():
    """At the embedding blocks' (B, 256, 1, 1) map the softmax is over one
    key, so the block is exactly gamma * v(x) + x; q and k reach the
    attention with both strides 1."""
    torch.manual_seed(0)
    blk = SelfAttentionBlock(256, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        blk.gamma.fill_(0.37)
        x = torch.randn(4, 256, 1, 1)
        q = blk.q(x).reshape(4, 32, 1).transpose(1, 2)
        assert q.shape == (4, 1, 32) and q.stride(1) == q.stride(2) == 1
        assert torch.equal(blk(x), blk.gamma * blk.v(x) + x)


def test_both_conditioning_branches_exist_and_differ(nets):
    """Both branches are built in __init__ (the reference's keys, with no
    init_all), and the two paths give different maps."""
    _, _, gv, _ = nets
    model = port_g(gv).eval()
    keys = model.state_dict().keys()
    assert "embeding_block.label_encode_block.attention.2.gamma" in keys
    assert "style_encoder.style_encode_block.convs.3.conv.0.weight" in keys
    imgs, _, labels, styles = inputs(3)
    with torch.no_grad():
        a = model(to_nchw(imgs, torch.float32), cond_torch(labels, styles, torch.float32))
        b = model(to_nchw(imgs, torch.float32))
    assert not torch.allclose(a["masks"], b["masks"])
