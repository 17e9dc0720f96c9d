"""The port's BC ComposeNet (vaeplay_torch.models.bc) against the JAX
package's, on the CPU at a small size (the (1, 1, 1, 1) x 16 backbone, 64
px, batch 2, 16 contour points; the feature width stays 258, the FPN's 256
and two coordinate channels): the weight conversion both ways, the forward
in train and eval mode with injected contours, the traced contours, the
BatchNorm running statistics, bicubic point sampling, the one-hot
embedding, RefineNet with f32 and bf16 linear layers, the chamfer loss, the
f64 gradients of every trainable tensor and one Adam step.

Contours are a discontinuous function of the mask, so every parity test of
the refine stage, the losses and the gradients injects the same (pts,
counts) on both sides; the traced contours are held apart, on inputs whose
mask probabilities all lie more than 1e-6 from the 0.5 threshold."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from vaeplay_torch.eval.viz_points import draw_closed_contour
from vaeplay_torch.models import bc as TB
from vaeplay_torch.models.backbone import FrozenBatchNorm2d
from vaeplay_torch.models.convert import bc_state_dict_from_jax
from vaeplay_torch.ops import image as TI
from vaeplay_torch.ops import losses as TLoss
from vaeplay_torch.train import steps_bc as TS
from vaeplay_torch.train.state import frozen_backbone_adam
from vaeplay_tpu.core import layers as JL
from vaeplay_tpu.eval import viz_points as JV
from vaeplay_tpu.models import bc as JB
from vaeplay_tpu.models.torch_convert import bc_from_torch
from vaeplay_tpu.ops import image as JI
from vaeplay_tpu.ops import losses as JLoss
from vaeplay_tpu.train.state import TrainState as JaxTrainState
from vaeplay_tpu.train.state import frozen_backbone_adam as jax_frozen_backbone_adam
from vaeplay_tpu.train.state import stop_frozen_gradients

SLIM, WIDTH, IMG, B, MP, LR = (1, 1, 1, 1), 16, 64, 2, 16, 1e-4
TOL = 1e-4        # f32 forward: of each output's largest magnitude, plus relative
F64_TOL = 1e-9    # f64 gradients: of each tensor's largest magnitude
PROB_MARGIN = 1e-6  # traced-contour inputs: every |sigmoid(logit) - 0.5| above this
MASK_BN = ("c1a", "c1b", "c1c", "c2a", "c2b")
# an attention block's k bias moves every score of a query row by the same
# q . dk wherever its ReLU is open, which the softmax takes out: its true
# gradient is (near) 0, so it is held to its layer's kernel gradient's scale
ZERO_GRADS = {("refine_net", f"attn{i}", "k", "conv", "bias"):
              ("refine_net", f"attn{i}", "k", "conv", "kernel") for i in range(6)}


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two torch threads a process: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def randomize(v, seed: int = 0):
    """(params, batch_stats, constants) of a JAX BC init with every
    FrozenBatchNorm constant, BatchNorm scale, bias and statistic, and every
    bias drawn, and every attention gamma at +-[0.2, 0.6] (they start at 0,
    which would hide the attention)."""
    rng = np.random.default_rng(seed)
    params = traverse_util.flatten_dict(jax.device_get(v["params"]))
    for k in params:
        if k[-1] == "scale":
            params[k] = rng.uniform(0.5, 1.5, params[k].shape).astype(np.float32)
        elif k[-1] == "bias":
            params[k] = rng.uniform(-0.2, 0.2, params[k].shape).astype(np.float32)
        elif k[-1] == "gamma":
            params[k] = (rng.choice([-1.0, 1.0]) * rng.uniform(0.2, 0.6, (1,))).astype(np.float32)
    stats = traverse_util.flatten_dict(jax.device_get(v["batch_stats"]))
    for k in stats:
        low, high = (0.5, 2.0) if k[-1] == "var" else (-0.5, 0.5)
        stats[k] = rng.uniform(low, high, stats[k].shape).astype(np.float32)
    consts = traverse_util.flatten_dict(jax.device_get(v["constants"]))
    ranges = {"scale": (0.3, 0.8), "bias": (-0.1, 0.1), "mean": (-0.1, 0.1), "var": (0.5, 1.5)}
    for k in consts:
        consts[k] = rng.uniform(*ranges[k[-1]], consts[k].shape).astype(np.float32)
    return tuple(traverse_util.unflatten_dict(t) for t in (params, stats, consts))


@pytest.fixture(scope="module")
def jax_model():
    """The slim JAX ComposeNet, randomized trees and its init (the
    converter's template)."""
    model = JB.ComposeNet(max_points=MP, backbone_layers=SLIM, backbone_width=WIDTH)
    v = jax.device_get(jax.jit(lambda x: model.init({"params": jax.random.PRNGKey(0)}, x,
                                                     contours=_contours(0)))(
        jnp.zeros((1, IMG, IMG, 3))))
    return (model, *randomize(v), v)


def port_model(params, stats, consts, dtype=torch.float32,
               fc_dtype=torch.float32) -> TB.ComposeNet:
    port = TB.ComposeNet(MP, refine_fc_dtype=fc_dtype, backbone_layers=SLIM,
                         backbone_width=WIDTH)
    port.load_state_dict(bc_state_dict_from_jax(params, stats, consts))
    return port.to(dtype) if dtype != torch.float32 else port


def images(seed, dtype=np.float32, batch=B):
    """Uniform-noise NHWC images: no exact zeros at the ReLUs, no ties in the
    max pool."""
    return np.random.default_rng(seed).uniform(size=(batch, IMG, IMG, 3)).astype(dtype)


def _contours(seed, batch=1):
    """Injected (pts, counts): integer points, most of them where the stride-4
    feature map has values (the reference's normalization puts any point
    past about x, y = 20 outside it at 64 px), a few beyond."""
    rng = np.random.default_rng(100 + seed)
    pts = rng.integers(0, 22, size=(batch, MP, 2)).astype(np.float32)
    pts[:, -3:] = rng.integers(22, IMG + 2, size=(batch, 3, 2))
    counts = np.asarray([MP, MP - 5, 0, 7][:batch], np.int32)
    return pts, counts


def dyadic_contours(seed, batch=B):
    """Injected points whose normalized and unnormalized sampling coordinates
    and bicubic weights are exact in f32: x = 8.5 (1 + k / 16) for integer
    k (the padded 18 px map's half-extent is 8.5), so the JAX sampler's f32
    weights equal f64 ones and an f64 comparison can hold 1e-9."""
    rng = np.random.default_rng(200 + seed)
    k = rng.integers(-20, 21, size=(batch, MP, 2))
    return 8.5 * (1.0 + k / 16.0), np.asarray([MP, MP - 5, 9][:batch], np.int32)


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def flat(tree):
    return traverse_util.flatten_dict(jax.device_get(tree))


def jax_forward(model, train: bool):
    """The JAX forward, jitted: (variables, x, contours) -> (preds, the
    batch_stats it leaves); contours None traces them in a callback."""
    def forward(variables, x, contours):
        if train:
            return model.apply(variables, x, train=True, contours=contours,
                               mutable=["batch_stats"])
        return model.apply(variables, x, train=False, contours=contours), {}
    return jax.jit(forward)


def _close(got: torch.Tensor, want, tol=TOL, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol * np.abs(want).max(),
                               rtol=tol, err_msg=name)


def _check_preds(got, want):
    for k in ("edges", "masks"):
        w = np.transpose(np.asarray(want[k]), (0, 3, 1, 2))
        assert got[k].shape == (B, 1, IMG, IMG)
        _close(got[k], w, name=k)
    assert got["contour_regressions"].shape == (B, MP, 2)
    _close(got["contour_regressions"], want["contour_regressions"], name="regressions")


def test_converter_round_trip(jax_model):
    """JAX variables -> bc_state_dict_from_jax -> the port (a strict load) ->
    its state_dict -> the JAX package's bc_from_torch gives the JAX trees
    back exactly; the port's keys are the reference's."""
    _, params, stats, consts, template = jax_model
    sd = {k: v.numpy() for k, v in port_model(params, stats, consts).state_dict().items()}
    back = bc_from_torch(sd, template)
    for got, want in zip(back, (params, stats, consts)):
        got, want = flat(got), flat(want)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=str(k))
    for key in ("feature_net.feature.body.layer1.0.downsample.1.running_var",
                "feature_net.feature.fpn.layer_blocks.3.bias",
                "mask_net.conv1.2.conv.1.running_mean", "mask_net.conv2.1.conv.0.weight",
                "mask_net.predictor.1.conv.0.bias", "edge_net.conv1.2.conv.0.weight",
                "edge_net.predictor.1.conv.0.bias", "refine_net.deform_blocks.5.q.conv.0.bias",
                "refine_net.deform_blocks.0.gamma", "refine_net.fc_blocks.1.bias"):
        assert key in sd, key
    assert sd["refine_net.fc_blocks.0.weight"].shape == (MP * 258 // 8, MP * 258)
    assert sd["refine_net.deform_blocks.0.q.conv.0.weight"].shape == (MP // 8, MP, 1, 1)


@pytest.mark.parametrize("train", [True, False])
def test_forward_matches_jax(jax_model, train):
    """Edges, masks and regressions, f32, with the same injected contours:
    train mode normalizes the BatchNorms with the batch's statistics, eval
    mode with the (drawn) running ones."""
    model, params, stats, consts, _ = jax_model
    x = images(1)
    pts, counts = _contours(1, B)
    want = jax_forward(model, train)({"params": params, "batch_stats": stats, "constants": consts},
                                     jnp.asarray(x), (jnp.asarray(pts), jnp.asarray(counts)))[0]
    port = port_model(params, stats, consts).train(train)
    with torch.no_grad():
        got = port(nchw(x), contours=(torch.from_numpy(pts), torch.from_numpy(counts)))
    _check_preds(got, want)
    assert torch.equal(got["contours"], torch.from_numpy(pts))
    assert got["contour_regressions"][0].abs().max() > 0


def _threshold_safe_images(model, variables):
    """The first of seeds 0-19 whose mask probabilities (the JAX eval
    forward's) all lie more than PROB_MARGIN from 0.5, so the trace cannot
    depend on the frameworks' rounding."""
    probs = jax.jit(lambda v, x: model.apply(v, x, train=False, method=model.mask_probs))
    for seed in range(20):
        x = images(10 + seed)
        p = np.asarray(probs(variables, jnp.asarray(x)))[:, 1:-1, 1:-1]
        if np.abs(p - 0.5).min() > PROB_MARGIN:
            return x
    raise AssertionError("no threshold-safe input among 20 seeds")


def test_traced_contours_match_jax(jax_model):
    """contours=None on both sides, eval mode, on threshold-safe inputs: the
    traced points and counts equal the JAX callback's, and the regressions
    agree within TOL."""
    model, params, stats, consts, _ = jax_model
    variables = {"params": params, "batch_stats": stats, "constants": consts}
    x = _threshold_safe_images(model, variables)
    want = jax_forward(model, False)(variables, jnp.asarray(x), None)[0]
    port = port_model(params, stats, consts).eval()
    calls = TB.trace_contours.calls
    with torch.no_grad():
        got = port(nchw(x))
    assert TB.trace_contours.calls == calls + 1
    assert got["contours"].dtype == torch.float32 and got["contour_counts"].dtype == torch.int32
    np.testing.assert_array_equal(got["contour_counts"].numpy(), np.asarray(want["contour_counts"]))
    np.testing.assert_array_equal(got["contours"].numpy(), np.asarray(want["contours"]))
    assert got["contour_counts"].min() > 0
    _check_preds(got, want)


def test_mask_bits_and_probs_match_jax(jax_model):
    """mask_probs, mask_binary and mask_bits (stride 1 and 4) against the JAX
    methods, eval mode, on threshold-safe inputs."""
    model, params, stats, consts, _ = jax_model
    variables = {"params": params, "batch_stats": stats, "constants": consts}
    x = _threshold_safe_images(model, variables)

    @jax.jit
    def jax_masks(v, a):
        run = lambda method, **kw: model.apply(v, a, train=False, method=method, **kw)
        return (run(model.mask_probs), run(model.mask_binary)[..., 0],
                run(model.mask_bits, stride=1), run(model.mask_bits, stride=4))

    want = [np.asarray(t) for t in jax_masks(variables, jnp.asarray(x))]
    port = port_model(params, stats, consts).eval()
    with torch.no_grad():
        got = (port.mask_probs(nchw(x)), port.mask_binary(nchw(x))[:, 0],
               port.mask_bits(nchw(x), stride=1), port.mask_bits(nchw(x), stride=4))
    assert got[0].shape == (B, 1, IMG + 2, IMG + 2) and got[3].shape == (B, 17, 3)
    _close(got[0], np.transpose(want[0], (0, 3, 1, 2)), name="mask_probs")
    for name, g, w in zip(("mask_binary", "mask_bits 1", "mask_bits 4"), got[1:], want[1:]):
        assert g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def _bn_elements(key) -> int:
    """Elements per channel behind one BN update: MaskNet's conv1 runs at
    IMG / 4, its conv2 at IMG / 2."""
    side = IMG // 4 if key[1].startswith("c1") else IMG // 2
    return B * side * side


def test_running_statistics_match_jax(jax_model):
    """After one training forward: running_mean as JAX's within 1e-5;
    running_var with the batch variance's n / (n - 1) factor taken out
    (torch updates it with the unbiased variance, flax with the biased)."""
    model, params, stats, consts, template = jax_model
    x = images(2)
    pts, counts = _contours(2, B)
    _, mut = jax_forward(model, True)({"params": params, "batch_stats": stats, "constants": consts},
                                      jnp.asarray(x), (jnp.asarray(pts), jnp.asarray(counts)))
    port = port_model(params, stats, consts).train()
    with torch.no_grad():
        port(nchw(x), contours=(torch.from_numpy(pts), torch.from_numpy(counts)))
    got = flat(bc_from_torch({k: v.numpy() for k, v in port.state_dict().items()}, template)[1])
    want, old = flat(mut["batch_stats"]), flat(stats)
    assert sorted(got) == sorted(want) and len(want) == 2 * len(MASK_BN)
    for key in want:
        if key[-1] == "mean":
            np.testing.assert_allclose(got[key], want[key], atol=1e-5, rtol=1e-5, err_msg=str(key))
            continue
        n = _bn_elements(key)
        np.testing.assert_allclose((got[key] - 0.9 * old[key]) * (n - 1) / n,
                                   want[key] - 0.9 * old[key], atol=1e-5, rtol=1e-4,
                                   err_msg=str(key))
    for m in port.modules():
        if isinstance(m, FrozenBatchNorm2d):
            assert not any(t.requires_grad for t in m.buffers())


def test_bicubic_point_sample_matches_jax():
    """point_sample_ng with mode "bicubic", align_corners False (BC's
    resample): values and the feature gradient (JAX's scatter-free custom
    VJP) at points inside, on the edge of and outside [-1, 1]."""
    rng = np.random.default_rng(5)
    feat = rng.normal(size=(2, 9, 11, 5)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, size=(2, 40, 2)).astype(np.float32)
    grid[:, :4] = [[-1.0, -1.0], [1.0, 1.0], [-1.0, 1.0], [0.0, 0.0]]
    cot = rng.normal(size=(2, 40, 5)).astype(np.float32)

    @jax.jit
    def sample_and_vjp(f, g, c):
        out, vjp = jax.vjp(lambda t: JI.point_sample_ng(t, g, False, "bicubic"), f)
        return out, vjp(c)[0]

    want, want_g = sample_and_vjp(*map(jnp.asarray, (feat, grid, cot)))
    want_g = np.transpose(np.asarray(want_g), (0, 3, 1, 2))
    f = nchw(feat).requires_grad_()
    got = TI.point_sample_ng(f, torch.from_numpy(grid), False, "bicubic")
    got.backward(torch.from_numpy(cot))
    _close(got, want, 1e-5, "values")
    _close(f.grad, want_g, 1e-5, "feature gradient")


def test_resample_feature_matches_jax():
    """resample_feature_batched: the reference's half-extent normalization of
    full-resolution points, zero past each count."""
    rng = np.random.default_rng(6)
    feat = rng.normal(size=(3, 18, 18, 7)).astype(np.float32)
    pts, counts = rng.integers(0, 30, size=(3, MP, 2)).astype(np.float32), np.asarray([MP, 4, 0])
    want = JB.resample_feature_batched(jnp.asarray(feat), jnp.asarray(pts), jnp.asarray(counts))
    got = TB.resample_feature_batched(nchw(feat), torch.from_numpy(pts), torch.from_numpy(counts))
    _close(got, want, 1e-5)
    assert not got[1, 4:].any() and not got[2].any()


def test_make_embedding_tensor_matches_jax():
    pts = np.asarray([[[1.0, 2.0], [3.0, 0.0], [9.0, 9.0], [-2.0, 1.5]],
                      [[0.0, 0.0], [5.7, 5.2], [2.0, 1.0], [3.0, 3.0]]], np.float32)
    counts = np.asarray([3, 2], np.int32)
    want = np.asarray(JB.make_embedding_tensor(jnp.asarray(pts), jnp.asarray(counts), 4, 6))
    got = TB.make_embedding_tensor(torch.from_numpy(pts), torch.from_numpy(counts), 4, 6)
    assert got.dtype == torch.float32 and got.shape == (2, 4, 4, 6)
    np.testing.assert_array_equal(got.numpy(), want)


def _refine_inputs(seed):
    return np.random.default_rng(seed).normal(size=(B, MP, 258)).astype(np.float32) * 0.3


@pytest.mark.parametrize("fc_dtype", ["float32", "bfloat16"])
def test_refine_net_matches_jax(jax_model, fc_dtype):
    """RefineNet alone, eval mode, with its linear layers and their math in
    f32 or bf16 on both sides (the bf16 weights the same values): f32 within
    TOL; bf16 within 2e-2 of the output's largest magnitude, the two
    frameworks' bf16 GEMMs rounding fc0's 516 outputs each on its own."""
    _, params, stats, consts, _ = jax_model
    jdt = jnp.dtype(fc_dtype)
    model = JB.ComposeNet(max_points=MP, backbone_layers=SLIM, backbone_width=WIDTH,
                          refine_fc_dtype=fc_dtype)
    p = jax.tree_util.tree_map(lambda a: a, params)
    for name in ("fc0", "fc1"):
        p["refine_net"][name] = {k: jnp.asarray(a, jdt) for k, a in p["refine_net"][name].items()}
    x = _refine_inputs(7)
    want = model.apply({"params": p, "batch_stats": stats, "constants": consts}, jnp.asarray(x),
                       method=lambda m, f: m.refine_net(f, train=False))
    assert want.dtype == jnp.float32
    port = port_model(p, stats, consts, fc_dtype=getattr(torch, fc_dtype)).eval()
    assert port.refine_net.fc_blocks[0].weight.dtype == getattr(torch, fc_dtype)
    with torch.no_grad():
        got = port.refine_net(torch.from_numpy(x))
    assert got.dtype == torch.float32
    if fc_dtype == "float32":
        _close(got, want)
    else:
        w = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), w, atol=2e-2 * np.abs(w).max(), rtol=0)


def test_refine_fc_bf16_parity(jax_model):
    """The port's counterpart of tests/test_bc.py::test_refine_fc_bf16_parity:
    bf16 linear layers agree with f32 within 1e-2 of the output's largest
    magnitude on the same (bf16-representable) weights."""
    _, params, stats, consts, _ = jax_model
    p = jax.tree_util.tree_map(lambda a: a, params)
    for name in ("fc0", "fc1"):
        p["refine_net"][name] = {k: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                                 for k, a in p["refine_net"][name].items()}
    x = torch.from_numpy(_refine_inputs(8))
    with torch.no_grad():
        y32 = port_model(p, stats, consts).eval().refine_net(x)
        y16 = port_model(p, stats, consts, fc_dtype=torch.bfloat16).eval().refine_net(x)
    assert y16.dtype == torch.float32
    assert float((y32 - y16).abs().max() / y32.abs().max()) < 1e-2


def _chamfer_inputs(seed):
    """Random, non-degenerate f64 point sets (no distance ties); sample 2 has
    no predicted point, sample 1 a partial target and key set."""
    rng = np.random.default_rng(seed)
    b, n, m, k = 3, 12, 10, 5
    pred_pts = rng.uniform(0, 40, (b, n, 2))
    pred_mask = (np.arange(n)[None] < np.asarray([n, 7, 0])[:, None]).astype(np.float64)
    reg = rng.normal(size=(b, n, 2)) * 3.0
    tgt = rng.uniform(0, 40, (b, m, 2))
    tmask = (np.arange(m)[None] < np.asarray([m, 4, 6])[:, None]).astype(np.float64)
    key = rng.uniform(0, 40, (b, k, 2))
    kmask = (np.arange(k)[None] < np.asarray([k, 2, 3])[:, None]).astype(np.float64)
    return pred_pts, pred_mask, reg, tgt, tmask, key, kmask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chamfer_loss_matches_jax(seed):
    """Value and gradient (with respect to the regressions) in f64 within
    1e-12 relative; a sample with no predicted point contributes exactly 0."""
    args = _chamfer_inputs(seed)
    with jax.enable_x64(True):
        f = lambda r: JLoss.chamfer_pt_regression_loss(*map(jnp.asarray, args[:2]), r,
                                                       *map(jnp.asarray, args[3:]))
        want, want_g = jax.jit(jax.value_and_grad(f))(jnp.asarray(args[2]))
        want, want_g = float(want), np.asarray(want_g)
    t = [torch.from_numpy(a) for a in args]
    reg = t[2].clone().requires_grad_()
    got = TLoss.chamfer_pt_regression_loss(t[0], t[1], reg, *t[3:])
    got.backward()
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-12)
    np.testing.assert_allclose(reg.grad.numpy(), want_g, rtol=1e-10,
                               atol=1e-12 * np.abs(want_g).max())
    assert not reg.grad[2].any()
    only = TLoss.chamfer_pt_regression_loss(*(x[2:] for x in t[:2]), reg[2:].detach(),
                                            *(x[2:] for x in t[3:]))
    assert float(only) == 0.0


def _f64_attention(q, k, v):
    """Unscaled softmax attention in the inputs' dtype: the JAX package's
    plain attention computes its scores in f32 even under x64
    (`preferred_element_type`), so the f64 recipe swaps in this."""
    attn = jax.nn.softmax(jnp.einsum("bnd,bmd->bnm", q, k), axis=-1)
    return jnp.einsum("bnm,bmc->bnc", attn, v)


def jax_f64_recipe(model, monkeypatch):
    """The JAX BC step's loss (steps_bc.py:38-61) in f64, composed from its
    modules: ComposeNet's forward with the resampled features left f64 (its
    resample_feature_batched casts them to f32) and f64 attention. Returns
    loss_fn(params, batch_stats, constants, imgs, pts, counts, bimgs, eimgs,
    tgt_pts, tgt_mask, key_pts, key_mask) -> (total, (losses, batch_stats))."""
    monkeypatch.setattr(JL, "spatial_self_attention", lambda q, k, v, ring=None:
                        _f64_attention(q, k, v))

    def forward(m, x, pts, counts):
        feature = m.feature_net(x, train=True)
        mask_out = m.mask_net(feature, train=True)
        edge_out = m.edge_net(mask_out, train=True)
        fp = JL.add_coords(jnp.pad(feature, ((0, 0), (1, 1), (1, 1), (0, 0))))
        hf, wf = fp.shape[1:3]
        wh, hh = (wf - 1) / 2.0, (hf - 1) / 2.0
        grid = jnp.stack([(pts[..., 0] - wh) / wh, (pts[..., 1] - hh) / hh], axis=-1)
        sampled = JI.point_sample_ng(fp, grid, False, "bicubic")
        valid = (jnp.arange(pts.shape[1])[None, :] < counts[:, None])[..., None]
        return edge_out, mask_out, m.refine_net(sampled * valid, train=True)

    def loss_fn(params, bs, consts, imgs, pts, counts, bimgs, eimgs, tgt_pts, tgt_mask,
                key_pts, key_mask):
        params = stop_frozen_gradients(params)
        (edges, masks, reg), mut = model.apply(
            {"params": params, "batch_stats": bs, "constants": consts}, imgs, pts, counts,
            method=forward, mutable=["batch_stats"])
        le = JLoss.mask_edge_losses(edges, eimgs)
        lm = JLoss.mask_edge_losses(masks, bimgs)
        pred_mask = (jnp.arange(pts.shape[1])[None, :] < counts[:, None]).astype(reg.dtype)
        lr = JLoss.chamfer_pt_regression_loss(pts, pred_mask, reg, tgt_pts, tgt_mask, key_pts,
                                              key_mask)
        return le + lm + lr, ({"loss_edge": le, "loss_mask": lm, "loss_regress": lr},
                              mut["batch_stats"])

    return loss_fn


def f64_batch(seed):
    """Noise images, bubble-like masks, injected dyadic contours and target
    and key points, all f64 (the images and targets f32-representable)."""
    rng = np.random.default_rng(seed)
    imgs = images(seed, np.float64)
    yy, xx = np.mgrid[0:IMG, 0:IMG]
    bimgs = np.stack([(((xx - 30 - 4 * i) / 18.0) ** 2 + ((yy - 28) / 14.0) ** 2 <= 1.0)
                      for i in range(B)])[..., None].astype(np.float64)
    eimgs = np.stack([(((xx - 30 - 4 * i) / 18.0) ** 2 + ((yy - 28) / 14.0) ** 2 <= 1.0)
                      & (((xx - 30 - 4 * i) / 18.0) ** 2 + ((yy - 28) / 14.0) ** 2 >= 0.75)
                      for i in range(B)])[..., None].astype(np.float64)
    pts, counts = dyadic_contours(seed)
    tgt = rng.integers(0, IMG, (B, MP, 2)).astype(np.float64)
    tmask = (np.arange(MP)[None] < np.asarray([MP, 9])[:, None]).astype(np.float64)
    key = rng.integers(0, IMG, (B, 8, 2)).astype(np.float64)
    kmask = (np.arange(8)[None] < np.asarray([8, 3])[:, None]).astype(np.float64)
    return imgs, bimgs, eimgs, pts, counts, tgt, tmask, key, kmask


@pytest.fixture(scope="module")
def jax_f64_step(jax_model):
    """One step of the JAX BC recipe in f64 (jax_f64_recipe, then
    frozen_backbone_adam): its losses, gradients, new state."""
    model, params, stats, consts, _ = jax_model
    model64 = JB.ComposeNet(max_points=MP, backbone_layers=SLIM, backbone_width=WIDTH,
                            refine_fc_dtype="float64")
    batch = f64_batch(3)
    imgs, bimgs, eimgs, pts, counts, tgt, tmask, key, kmask = batch
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        loss_fn = jax_f64_recipe(model64, mp)
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
        consts64 = cast(consts)
        state = JaxTrainState.create(model64.apply, cast(params), cast(stats),
                                     jax_frozen_backbone_adam(LR), constants=consts64)

        @jax.jit
        def step(state, *arrays):
            grads, (m, bs) = jax.grad(loss_fn, has_aux=True)(state.params, state.batch_stats,
                                                              consts64, *arrays)
            return state.apply_gradients(grads, new_batch_stats=bs), m, grads

        args = (imgs, pts, counts, bimgs, eimgs, tgt, tmask, key, kmask)
        new_state, m, grads = jax.device_get(step(state, *map(jnp.asarray, args)))
    return batch, m, flat(grads), new_state


def _from_torch(sd, template):
    """bc_from_torch in x64 mode (its backbone transplant makes jnp arrays,
    which would round f64 to f32 outside it)."""
    with jax.enable_x64(True):
        return tuple(flat(t) for t in bc_from_torch(sd, template))


def port_grads(port, template):
    """The port's .grad per parameter as the JAX params tree (flattened); a
    parameter with no gradient gives None."""
    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    sd.update({k: p.grad.numpy() for k, p in port.named_parameters() if p.grad is not None})
    sd.update({k: np.full(p.shape, np.nan) for k, p in port.named_parameters() if p.grad is None})
    tree = _from_torch(sd, template)[0]
    return {k: (None if np.isnan(v).all() else v) for k, v in tree.items()}


def frozen_or_unread(key) -> str:
    """Why a JAX gradient is exactly zero: the frozen stem/layer1, or an FPN
    level BC never reads (its 3x3 output conv)."""
    if key[:2] != ("feature_net", "feature"):
        return ""
    if key[3] == "conv1" or key[3].startswith("layer1_"):
        return "frozen"
    if key[2] == "fpn" and key[3] in ("layer1", "layer2", "layer3"):
        return "unread"
    return ""


def port_step_inputs(batch, dtype=torch.float64):
    imgs, bimgs, eimgs, pts, counts, tgt, tmask, key, kmask = batch
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dtype)
    return ((nchw(imgs).to(dtype), nchw(bimgs).to(dtype), nchw(eimgs).to(dtype), t(tgt), t(tmask),
             t(key), t(kmask)), (t(pts), torch.from_numpy(counts)))


def test_f64_gradients_match_jax(jax_model, jax_f64_step):
    """The three losses within 1e-10, and every trainable tensor's gradient in
    f64 within 1e-9 of its largest magnitude, against the JAX recipe with
    the same injected contours; the frozen stem and layer1, and the 3x3
    convs of the FPN levels BC never reads, get no gradient at all (JAX's
    are exactly zero)."""
    _, params, stats, consts, template = jax_model
    batch, jm, want, _ = jax_f64_step
    port = port_model(params, stats, consts, torch.float64).train()
    frozen_backbone_adam(port, LR)  # turns off the stem's and layer1's requires_grad
    (imgs, bimgs, eimgs, *targets), contours = port_step_inputs(batch)
    m = TS.bc_losses(port(imgs, contours=contours), bimgs, eimgs, *targets)
    sum(m.values()).backward()
    for k in TS.METRIC_KEYS:
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]), rtol=1e-10, err_msg=k)
    got = port_grads(port, template)
    assert sorted(got) == sorted(want)
    counts = {"frozen": 0, "unread": 0, "": 0}
    for k, w in want.items():
        why = frozen_or_unread(k)
        counts[why] += 1
        if why:
            assert got[k] is None and not np.asarray(w).any(), k
            continue
        scale = np.abs(want[ZERO_GRADS[k]] if k in ZERO_GRADS else w).max()
        np.testing.assert_allclose(got[k], w, atol=F64_TOL * scale, rtol=0, err_msg=str(k))
    assert counts["frozen"] == 1 + 4 and counts["unread"] == 6 and counts[""] > 50
    assert np.abs(want[("refine_net", "fc0", "kernel")]).max() > 0
    assert np.abs(want[("refine_net", "attn0", "gamma")]).max() > 0


def test_one_adam_step_matches_jax(jax_model, jax_f64_step):
    """One f64 step through make_bc_train_step with injected contours and
    frozen_backbone_adam against the JAX step: every weight within 1e-9 of
    its largest magnitude plus the update's slope at g = 0 (lr / eps = 1e4)
    times its gradients' difference; Adam's moments within 1e-9; the frozen
    stem and layer1 and every FrozenBatchNorm buffer unchanged bit for bit;
    BN means within 1e-10 relative, variances (n / (n - 1) taken out)
    within 1e-8 of their largest."""
    _, params, stats, consts, template = jax_model
    batch, jm, want_g, jstate = jax_f64_step
    port = port_model(params, stats, consts, torch.float64).train()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    state = frozen_backbone_adam(port, LR)
    (imgs, bimgs, eimgs, *targets), contours = port_step_inputs(batch)
    state, metrics = TS.make_bc_train_step(port)(state, imgs, bimgs, eimgs, *targets,
                                                 contours=contours)
    assert state.step == 1 and sorted(metrics) == sorted(TS.METRIC_KEYS)
    for k in TS.METRIC_KEYS:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), rtol=1e-10, err_msg=k)
    for name, p in port.named_parameters():
        if not p.requires_grad:
            assert p.grad is None and torch.equal(p, before[name]), name
            assert ".body.conv1." in name or ".body.layer1." in name, name
    for name, mod in port.named_modules():
        if isinstance(mod, FrozenBatchNorm2d):
            for b, t in mod.named_buffers():
                assert torch.equal(t, before[f"{name}.{b}"]), (name, b)

    got_g = port_grads(port, template)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    got_p, got_s, _ = _from_torch(sd, template)
    for k, w in flat(jstate.params).items():
        diff = 0.0 if got_g[k] is None else np.abs(got_g[k] - want_g[k])
        bound = F64_TOL * np.abs(w).max() + 1.001 * LR / 1e-8 * diff
        assert (np.abs(got_p[k] - w) <= bound).all(), ("parameter", k)
    names = {id(p): n for n, p in port.named_parameters()}
    inner = jstate.opt_state.inner_states["train"].inner_state[0]
    for moment, opt_key in ((inner.mu, "exp_avg"), (inner.nu, "exp_avg_sq")):
        sd_m = {k: np.zeros(v.shape) for k, v in sd.items()}
        sd_m.update({names[id(p)]: s[opt_key].numpy() for p, s in state.optimizer.state.items()})
        got_m = _from_torch(sd_m, template)[0]
        want_m = flat(moment)
        for k, w in want_m.items():
            if not isinstance(w, np.ndarray):  # optax's MaskedNode: a frozen tensor
                assert frozen_or_unread(k) == "frozen" and not got_m[k].any(), k
                continue
            scale = np.abs(want_m[ZERO_GRADS[k]] if k in ZERO_GRADS else w).max()
            np.testing.assert_allclose(got_m[k], w, atol=F64_TOL * scale, rtol=0,
                                       err_msg=f"{opt_key} {k}")
    want_s, old = flat(jstate.batch_stats), flat(stats)
    for key, w in want_s.items():
        if key[-1] == "mean":
            np.testing.assert_allclose(got_s[key], w, atol=1e-12, rtol=1e-10, err_msg=str(key))
        else:
            n = _bn_elements(key)
            np.testing.assert_allclose((got_s[key] - 0.9 * old[key]) * (n - 1) / n,
                                       w - 0.9 * old[key], atol=1e-8 * np.abs(w).max(), rtol=0,
                                       err_msg=str(key))


def test_draw_closed_contour_matches_jax():
    img = np.random.default_rng(9).uniform(size=(20, 24, 3)).astype(np.float32)
    pts = np.asarray([[2, 3], [15, 4], [18, 16], [5, 12], [1, 1]], np.float32)
    valid = np.asarray([1, 1, 1, 1, 0], bool)
    np.testing.assert_array_equal(draw_closed_contour(img, pts, (0, 255, 0), valid),
                                  JV.draw_closed_contour(img, pts, (0, 255, 0), valid))
