"""The port's BCP models (vaeplay_torch.models.bcp) against the JAX package's,
on the CPU at a small size (64 px, 64 points, batch 2; the encoder's two
towers cut to 2 blocks each and its map-size constant to 32, so the class
head widens to 2048 channels in 4 convolutions, not 6; every width else as
published): the weight conversion both ways in the merged and the dual
encoder layouts, G's forward with and without point attention in f32 and
f64, the class head's detach cut, D's forward, the point attention block's
layout, the bilinear point gather and the eval path's traced contours; and
the full-width models' parameter counts against the JAX package's.

The JAX package's bilinear gather computes its sampling weights in f32 even
under x64, and its plain attention its scores in f32
(`preferred_element_type`): the f64 comparisons inject "dyadic" contour
points, whose weights are exact in f32, and give the JAX model f64
attention."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from vaeplay_torch.core.layers import PointSelfAttentionBlock
from vaeplay_torch.data.bcp_data import SyntheticBCPDataset
from vaeplay_torch.models import bcp as TB
from vaeplay_torch.models.convert import bcp_disc_state_dict_from_jax, bcp_state_dict_from_jax
from vaeplay_torch.ops import attention
from vaeplay_torch.ops import image as TI
from vaeplay_tpu.core import layers as JL
from vaeplay_tpu.models import bcp as JB
from vaeplay_tpu.models.torch_convert import bcp_disc_from_torch, bcp_from_torch
from vaeplay_tpu.ops import image as JI

# OUT: the encoder's map-size constant, which sizes the heads (the
# reference's 128, the map at 512 px, in the converter round trip, whose
# JAX side assumes it)
IMG, P, B, BLOCKS, OUT = 64, 64, 2, 2, 32
TOL = 1e-4       # f32: of each output's largest magnitude, plus relative
F64_TOL = 1e-9   # f64: of each output's largest magnitude


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two torch threads a process: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def randomize(params, seed: int = 0):
    """A params tree with every bias drawn from +-0.2 and every attention
    gamma from +-[0.2, 0.6] (they start at 0, which would hide the
    attention and the biases' part)."""
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(jax.device_get(params))
    for k, v in flat.items():
        if k[-1] == "bias" or k[-1].startswith(("c0_bias", "c1_bias", "c2_bias")):
            flat[k] = rng.uniform(-0.2, 0.2, v.shape).astype(np.float32)
        elif k[-1] == "gamma":
            flat[k] = (rng.choice([-1.0, 1.0]) * rng.uniform(0.2, 0.6, (1,))).astype(np.float32)
    return traverse_util.unflatten_dict(flat)


def jax_g(point_attention: bool, out_size: int = OUT):
    return JB.ComposeNet(image_size=IMG, pt_size=P, point_attention=point_attention,
                         encoder_blocks=BLOCKS, encoder_out_size=out_size)


def jax_g_init(point_attention: bool, out_size: int = OUT, seed: int = 0):
    return jax.jit(jax_g(point_attention, out_size).init)(
        {"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1, P, 2)),
        jnp.ones((1,), jnp.int32))["params"]


def without_attention(params):
    return {**params, "line_predictor": {k: v for k, v in params["line_predictor"].items()
                                         if not k.startswith("battn")}}


@pytest.fixture(scope="module")
def jax_params():
    """Randomized params of the slim JAX G with point attention (the G
    without it takes the same tree less battn{0,1,2}) and of D."""
    dv = jax.jit(JB.Discriminator(image_size=IMG, pt_size=P).init)(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1, P, 4)))
    return randomize(jax_g_init(True), 0), randomize(dv["params"], 1)


def random_params(model, *args, seed: int = 0):
    """A params tree of the model's shapes (jax.eval_shape of its init, no
    compile) drawn from N(0, 0.05^2) with numpy: for the converter's round
    trip, which needs no trained or initialized values."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0)}, *args)["params"]
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape, dtype=np.float32) * 0.05), shapes)


def port_g(params, point_attention: bool, dtype=torch.float32, out_size: int = OUT
           ) -> TB.ComposeNet:
    """The port's G with the JAX params loaded (strictly; built on the meta
    device, so no init runs)."""
    with torch.device("meta"):
        g = TB.ComposeNet(P, point_attention, encoder_blocks=BLOCKS, encoder_out_size=out_size)
    g.load_state_dict(bcp_state_dict_from_jax(params), assign=True)
    return g.to(dtype)


def images(seed, dtype=np.float32):
    """Uniform-noise NHWC images: no exact zeros at the (leaky) ReLUs."""
    return np.random.default_rng(seed).uniform(size=(B, IMG, IMG, 3)).astype(dtype)


def contours(seed):
    """Points in [-1.2, 1.2] (a few outside the map) and counts (P, P - 9)."""
    pts = np.random.default_rng(50 + seed).uniform(-1.2, 1.2, (B, P, 2)).astype(np.float32)
    return pts, np.asarray([P, P - 9], np.int32)


def dyadic_contours(seed):
    """Points k / 32 for integer k in [-36, 36]: on the 16 px map the bilinear
    coordinates are k / 4 + 7.5, so the JAX package's f32 weights are exact."""
    k = np.random.default_rng(70 + seed).integers(-36, 37, (B, P, 2))
    return k / 32.0, np.asarray([P, P - 9], np.int32)


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def flat(tree):
    return traverse_util.flatten_dict(jax.device_get(tree))


def f64_attention(q, k, v, ring=None):
    """Unscaled softmax attention in the inputs' dtype (the JAX package's
    plain attention takes its scores in f32 even under x64)."""
    return jnp.einsum("bnm,bmc->bnc", jax.nn.softmax(jnp.einsum("bnd,bmd->bnm", q, k), -1), v)


def _close(got: torch.Tensor, want, tol, rtol, name):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, name
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol * np.abs(want).max(),
                               rtol=rtol, err_msg=name)


def test_converter_round_trip_merged_and_dual(jax_params):
    """JAX params -> bcp_state_dict_from_jax -> the port (strict loads) -> its
    state_dict -> the JAX package's bcp_from_torch / bcp_disc_from_torch
    gives the params back bit for bit, from the merged encoder layout (the
    JAX model's) and from the dual one (two towers); the port's keys are
    the reference's, and the attention blocks land under
    line_predictor.batch_attention. The heads are at the map constant 128
    (six class convs widening to 2048 channels)."""
    dp = jax_params[1]
    gp = random_params(jax_g(True, 128), jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1, P, 2)),
                       jnp.ones((1,), jnp.int32), seed=3)
    sd = {k: v.numpy() for k, v in port_g(gp, True, out_size=128).state_dict().items()}
    want = flat(without_attention(gp))
    got = flat(bcp_from_torch(sd, blocks=BLOCKS))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    for key in ("encoder.convs1.1.convs.2.conv.0.bias", "encoder.convs2.1.convs.1.conv.0.bias",
                "cls_classifier.convs.5.conv.0.weight", "cls_classifier.cls_convs.2.fc.0.bias",
                "line_predictor.frequency_encode_img.3.conv.0.bias",
                "line_predictor.frequency_pred.2.fc.0.weight"):
        assert key in sd, key
    for key in ("encoder.convs2.0.convs.0.conv.0.bias",  # instance norm: no bias
                "line_predictor.frequency_encode_img.2.conv.0.bias"):
        assert key not in sd, key
    np.testing.assert_array_equal(sd["line_predictor.batch_attention.2.gamma"],
                                  gp["line_predictor"]["battn2"]["gamma"])
    assert sd["line_predictor.batch_attention.0.q.conv.0.weight"].shape == (32, 260, 1, 1)

    dual = random_params(JB.ContentEndoer(blocks=BLOCKS, merged=False),
                         jnp.zeros((1, 16, 16, 5)), seed=5)
    gp_dual = {**without_attention(gp), "encoder": dual}
    sd = {k: v.numpy() for k, v in port_g(gp_dual, False, out_size=128).state_dict().items()}
    for got, want in ((bcp_from_torch(sd, blocks=BLOCKS, merged=False), gp_dual),
                      (bcp_from_torch(sd, blocks=BLOCKS),
                       {**gp_dual, "encoder": JB.merge_encoder_params(dual, BLOCKS)})):
        got, want = flat(got), flat(want)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))

    d = TB.Discriminator(IMG, P)
    d.load_state_dict(bcp_disc_state_dict_from_jax(dp, IMG))
    got = flat(bcp_disc_from_torch({k: v.numpy() for k, v in d.state_dict().items()}, IMG))
    assert sorted(got) == sorted(flat(dp))
    for k, w in flat(dp).items():
        np.testing.assert_array_equal(got[k], w, err_msg=str(k))


def test_full_width_parameter_counts_match_jax():
    """At the JAX CLIs' defaults (512 px, 2048 points, 8 blocks a tower, map
    constant 128), G with and without point attention and D hold as many
    parameters as the JAX models (shapes only, on the meta device and
    through jax.eval_shape); D's first local layer is 8192 -> 8192."""
    def jax_count(model, *args):
        shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0)}, *args)
        return sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))

    x = jnp.zeros((1, 512, 512, 3))
    with torch.device("meta"):
        ports = {pa: TB.ComposeNet(2048, pa) for pa in (False, True)}
        d = TB.Discriminator(512, 2048)
    for pa, g in ports.items():
        want = jax_count(JB.ComposeNet(pt_size=2048, point_attention=pa), x,
                         jnp.zeros((1, 2048, 2)), jnp.ones((1,), jnp.int32))
        assert sum(p.numel() for p in g.parameters()) == want, pa
    assert sum(p.numel() for p in d.parameters()) == jax_count(JB.Discriminator(), x,
                                                               jnp.zeros((1, 2048, 4)))
    assert d.local_convs[0].fc[0].weight.shape == (8192, 8192)
    assert len(ports[False].cls_classifier.convs) == 6
    assert len(ports[False].line_predictor.frequency_encode_img) == 3 + 1  # int(ln 128) - 1


@pytest.mark.parametrize("point_attention", [False, True])
def test_forward_f32_matches_jax(jax_params, point_attention):
    """classes, target_pts and target_frequency within 1e-4 of each output's
    largest magnitude plus 1e-4 relative, from the same weights, images and
    contours; padded points included."""
    gp = jax_params[0] if point_attention else without_attention(jax_params[0])
    x = images(1)
    pts, counts = contours(1)
    want = jax.jit(lambda p, *a: jax_g(point_attention).apply({"params": p}, *a))(
        gp, jnp.asarray(x), jnp.asarray(pts), jnp.asarray(counts))
    with torch.no_grad():
        got = port_g(gp, point_attention)(nchw(x), torch.from_numpy(pts),
                                          torch.from_numpy(counts))
    for k in ("classes", "target_pts", "target_frequency"):
        _close(got[k], want[k], TOL, TOL, k)
    assert torch.equal(got["contours"], torch.from_numpy(pts))


@pytest.mark.parametrize("point_attention", [False, True])
def test_forward_f64_matches_jax(jax_params, point_attention, monkeypatch):
    """The same outputs in f64 within 1e-9 of each output's largest
    magnitude, at dyadic contour points and with f64 attention on the JAX
    side."""
    gp = jax_params[0] if point_attention else without_attention(jax_params[0])
    x = images(2, np.float64)
    pts, counts = dyadic_contours(2)
    monkeypatch.setattr(JL, "spatial_self_attention", f64_attention)
    with jax.enable_x64(True):
        gp64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), gp)
        want = jax.device_get(jax.jit(lambda p, *a: jax_g(point_attention).apply(
            {"params": p}, *a))(gp64, jnp.asarray(x), jnp.asarray(pts), jnp.asarray(counts)))
    with torch.no_grad():
        got = port_g(gp, point_attention, torch.float64)(
            nchw(x), torch.from_numpy(pts), torch.from_numpy(counts))
    for k in ("classes", "target_pts", "target_frequency"):
        assert got[k].dtype == torch.float64 and np.asarray(want[k]).dtype == np.float64, k
        _close(got[k], want[k], F64_TOL, 0, k)


def test_line_losses_do_not_reach_the_class_head(jax_params):
    """The line predictor reads the class logits detached
    (networks_BCP.py:296): a loss on its outputs gives the class head no
    gradient, and the encoder and the line predictor one."""
    g = port_g(jax_params[0], True)
    pts, counts = contours(3)
    out = g(nchw(images(3)), torch.from_numpy(pts), torch.from_numpy(counts))
    loss = out["target_pts"].sum() + out["target_frequency"].sum()
    names, params = zip(*g.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, params, allow_unused=True)))
    for name, grad in grads.items():
        if name.startswith("cls_classifier."):
            assert grad is None, name
        else:
            assert grad is not None and bool(grad.abs().max() > 0), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_discriminator_matches_jax(jax_params, dtype):
    """D's probabilities from the same weights, images and zero-padded point
    sets, f32 within 1e-4 (plus 1e-4 relative) and f64 within 1e-9 of their
    largest."""
    dp = jax_params[1]
    npd = np.float32 if dtype == torch.float32 else np.float64
    x = images(4, npd)
    tgt = (np.random.default_rng(4).normal(size=(B, P, 4)) * 3).astype(npd)
    tgt[1, P - 9:] = 0
    with jax.enable_x64(dtype == torch.float64):
        dpc = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), npd), dp)
        want = jax.device_get(jax.jit(lambda p, *a: JB.Discriminator(
            image_size=IMG, pt_size=P).apply({"params": p}, *a))(dpc, x, tgt))
    d = TB.Discriminator(IMG, P)
    d.load_state_dict(bcp_disc_state_dict_from_jax(dp, IMG))
    with torch.no_grad():
        got = d.to(dtype)(nchw(x), torch.from_numpy(tgt))
    assert got.dtype == dtype
    if dtype == torch.float32:
        _close(got, want, TOL, TOL, "D")
    else:
        _close(got, want, F64_TOL, 0, "D")


def test_point_attention_block_matches_jax_and_keeps_the_kernel_layout(monkeypatch):
    """PointSelfAttentionBlock on (B, C, N) against the JAX block on (B, N,
    C), f32, with gamma and the biases drawn; and q, k, v reach the
    attention channel-major, in the layout the kernel reads with no copy
    (attention.kernel_operands returns k and v themselves, by the TMA)."""
    n, c = P, 260
    blk = JL.PointSelfAttentionBlock()
    x = np.random.default_rng(6).normal(size=(B, n, c)).astype(np.float32)
    p = randomize(jax.jit(blk.init)({"params": jax.random.PRNGKey(6)}, jnp.asarray(x))["params"])
    want = jax.jit(lambda p, a: blk.apply({"params": p}, a))(p, jnp.asarray(x))
    port = PointSelfAttentionBlock(c)
    sd = {}
    for name in ("q", "k", "v"):
        sd[f"{name}.conv.0.weight"] = torch.from_numpy(
            np.transpose(np.asarray(p[name]["conv"]["kernel"]), (3, 2, 0, 1)).copy())
        sd[f"{name}.conv.0.bias"] = torch.from_numpy(np.asarray(p[name]["conv"]["bias"]))
    sd["gamma"] = torch.from_numpy(np.asarray(p["gamma"]))
    port.load_state_dict(sd)
    seen = []

    def spy(q, k, v, ring=None):
        k_in, v_in, route = attention.kernel_operands(k, v)
        seen.append((k_in is k, v_in is v, route, q.stride(1), tuple(v.shape)))
        return attention.spatial_self_attention(q, k, v, ring=ring)

    from vaeplay_torch.core import layers as TLayers
    monkeypatch.setattr(TLayers, "spatial_self_attention", spy)
    xt = torch.from_numpy(x).transpose(1, 2).contiguous()  # (B, C, N)
    with torch.no_grad():
        got = port(xt)
    assert seen == [(True, True, "tma", 1, (B, n, c))]
    assert got.shape == (B, c, n)
    _close(got.transpose(1, 2), want, TOL, TOL, "attention block")


def test_bilinear_point_gather_matches_jax():
    """LinePredictor's gather: ops.image.grid_sample (bilinear,
    align_corners=False, zeros outside) on a 128-channel map, values and the
    gradient with respect to the map, against the JAX package's
    grid_sample, points inside and outside [-1, 1]."""
    rng = np.random.default_rng(7)
    feat = rng.normal(size=(B, 16, 16, 128)).astype(np.float32)
    grid = rng.uniform(-1.1, 1.1, (B, P, 2)).astype(np.float32)
    cot = rng.normal(size=(B, P, 128)).astype(np.float32)
    want, vjp = jax.vjp(lambda f: JI.grid_sample(f, jnp.asarray(grid), align_corners=False,
                                                 mode="bilinear"), jnp.asarray(feat))
    f = nchw(feat).requires_grad_()
    got = TI.grid_sample(f, torch.from_numpy(grid))
    got.backward(torch.from_numpy(cot))
    _close(got, want, 1e-5, 1e-5, "gather")
    _close(f.grad, np.transpose(np.asarray(vjp(jnp.asarray(cot))[0]), (0, 3, 1, 2)), 1e-5, 1e-5,
           "d gather / d map")


def test_eval_contours_from_masks_match_jax():
    """The eval path's contours and counts, traced on the host from channel 1
    at level 0.8, equal to the JAX package's."""
    imgs = SyntheticBCPDataset(img_size=IMG, max_points=P).sample_batch(3)["imgs"]
    imgs[2, :, :, 1] = 0  # no contour: count 0
    got = TB.eval_contours_from_masks(imgs, P)
    want = JB.eval_contours_from_masks(imgs, P)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[1][:2].min() > 0 and got[1][2] == 0
