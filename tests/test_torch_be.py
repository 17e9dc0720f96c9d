"""The port's BE ComposeNet (vaeplay_torch.models.be) against the JAX
package's, on the CPU at a small size (the (1, 1, 1, 1) x 16 backbone, 64
px, batch 2): the weight conversion both ways, the forward in train and
eval mode, the BatchNorm running statistics, the f64 gradients of every
trainable tensor, the frozen stem, one Adam step, the head loss, the layers
BE adds to the library, and the seeded init."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from vaeplay_torch.core import layers as TL
from vaeplay_torch.data.be_data import render_bubble_batch, sample_bubble_params
from vaeplay_torch.models import be as TBE
from vaeplay_torch.models.backbone import FrozenBatchNorm2d
from vaeplay_torch.models.convert import be_state_dict_from_jax
from vaeplay_torch.ops import losses as TLoss
from vaeplay_torch.train import steps_be as TS
from vaeplay_torch.train.state import frozen_backbone_adam
from vaeplay_tpu.core import layers as JL
from vaeplay_tpu.models.be import ComposeNet
from vaeplay_tpu.models.torch_convert import be_from_torch
from vaeplay_tpu.ops import losses as JLoss
from vaeplay_tpu.train.state import TrainState as JaxTrainState
from vaeplay_tpu.train.state import frozen_backbone_adam as jax_frozen_backbone_adam
from vaeplay_tpu.train.state import stop_frozen_gradients

SLIM, WIDTH, IMG, B, LR = (1, 1, 1, 1), 16, 64, 2, 1e-4
TOL = 1e-4        # f32 forward: of each output's largest magnitude, plus relative
F64_TOL = 1e-9    # f64 gradients: of each tensor's largest magnitude
# fpn.layer_blocks.0's output meets aux_convs.0, a 1x1 conv and a train-mode
# BatchNorm, which takes out any per-channel constant: its bias's true
# gradient is 0, so it is held to its layer's weight gradient's scale
ZERO_GRADS = {("feature_net", "backbone", "fpn", "layer0", "bias"):
              ("feature_net", "backbone", "fpn", "layer0", "kernel")}


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
    """The slim JAX ComposeNet's init (its variables as the converter's
    template), and the same trees with every FrozenBatchNorm constant, every
    BatchNorm scale, bias and running statistic, and every conv bias drawn,
    so that an identity or a swapped mapping shows."""
    model = ComposeNet(backbone_layers=SLIM, backbone_width=WIDTH)
    v = jax.device_get(jax.jit(model.init)({"params": jax.random.PRNGKey(0)},
                                           jnp.zeros((1, IMG, IMG, 3))))
    rng = np.random.default_rng(0)
    params = traverse_util.flatten_dict(v["params"])
    for k in params:
        if k[-1] == "scale":
            params[k] = rng.uniform(0.5, 1.5, params[k].shape).astype(np.float32)
        elif k[-1] == "bias":
            params[k] = rng.uniform(-0.2, 0.2, params[k].shape).astype(np.float32)
    stats = traverse_util.flatten_dict(v["batch_stats"])
    for k in stats:
        low, high = (0.5, 2.0) if k[-1] == "var" else (-0.5, 0.5)
        stats[k] = rng.uniform(low, high, stats[k].shape).astype(np.float32)
    consts = traverse_util.flatten_dict(v["constants"])
    ranges = {"scale": (0.3, 0.8), "bias": (-0.1, 0.1), "mean": (-0.1, 0.1), "var": (0.5, 1.5)}
    for k in consts:
        consts[k] = rng.uniform(*ranges[k[-1]], consts[k].shape).astype(np.float32)
    return (model, traverse_util.unflatten_dict(params), traverse_util.unflatten_dict(stats),
            traverse_util.unflatten_dict(consts), v)


def _port(params, stats, consts, dtype=torch.float32) -> TBE.ComposeNet:
    port = TBE.ComposeNet(SLIM, WIDTH)
    port.load_state_dict(be_state_dict_from_jax(params, stats, consts))
    return port.to(dtype)


def _batch(seed, dtype=np.float32):
    """Uniform-noise images (no exact zeros at the ReLUs, no ties in the max
    pool) and bubble masks, NHWC for JAX."""
    imgs = np.random.default_rng(seed).uniform(size=(B, IMG, IMG, 3)).astype(dtype)
    _, bimgs, eimgs = render_bubble_batch(IMG, torch.from_numpy(
        sample_bubble_params(IMG, B, seed=seed)[0]))
    nhwc = lambda t: np.ascontiguousarray(t.permute(0, 2, 3, 1).numpy(), dtype)
    return imgs, nhwc(bimgs), nhwc(eimgs)


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _flat(tree):
    return traverse_util.flatten_dict(jax.device_get(tree))


def _jax_forward(model, train: bool):
    """The JAX model's forward, jitted (op by op it takes seconds here):
    (variables, x) -> (preds, the batch_stats it leaves)."""
    def forward(variables, x):
        if train:
            return model.apply(variables, x, train=True, mutable=["batch_stats"])
        return model.apply(variables, x, train=False), {}
    return jax.jit(forward)


def test_converter_round_trip(jax_model):
    """JAX variables -> be_state_dict_from_jax -> the port (a strict load)
    -> its state_dict -> the JAX package's be_from_torch gives the JAX trees
    back exactly; the port's keys are the reference's."""
    _, params, stats, consts, template = jax_model
    sd = {k: v.numpy() for k, v in _port(params, stats, consts).state_dict().items()}
    back = be_from_torch(sd, template)
    for got, want in zip(back, (params, stats, consts)):
        got, want = _flat(got), _flat(want)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=str(k))
    for key in ("feature_net.backbone.body.layer1.0.downsample.1.running_var",
                "feature_net.backbone.fpn.layer_blocks.3.bias",
                "feature_net.aux_convs.5.conv.1.running_mean",
                "mask_net.conv1.conv.0.conv.0.weight", "edge_net.conv2.conv.1.conv.1.bias",
                "edge_net.predictor.2.conv.0.bias"):
        assert key in sd, key
    assert sd["mask_net.conv1.conv.0.conv.0.weight"].shape == (8, 34, 3, 3)  # 32 + 2 coords


@pytest.mark.parametrize("train", [True, False])
def test_forward_matches_jax(jax_model, train):
    """Both heads' logits, f32: train mode normalizes the BatchNorms with the
    batch's statistics, eval mode with the (drawn) running ones."""
    model, params, stats, consts, _ = jax_model
    x = _batch(1)[0]
    want = _jax_forward(model, train)({"params": params, "batch_stats": stats, "constants": consts},
                                      jnp.asarray(x))[0]
    port = _port(params, stats, consts).train(train)
    with torch.no_grad():
        got = port(_nchw(x))
    for k in ("edges", "masks"):
        w = np.transpose(np.asarray(want[k]), (0, 3, 1, 2))
        assert got[k].shape == (B, 1, IMG, IMG)
        np.testing.assert_allclose(got[k].numpy(), w, atol=TOL * np.abs(w).max(), rtol=TOL,
                                   err_msg=k)


def _bn_elements(key) -> int:
    """Elements per channel behind one BN update: the aux chain and Up 1's
    convs run at IMG / 4, Up 2's at IMG / 2."""
    side = IMG // 2 if key[1] == "up2" else IMG // 4
    return B * side * side


def test_running_statistics_match_jax(jax_model):
    """After one training forward (each BatchNorm updates once):
    running_mean as JAX's within 1e-5; running_var with the batch
    variance's n / (n - 1) factor taken out (torch updates it with the
    unbiased variance, flax with the biased one; ROADMAP queue 3). torch's
    momentum 0.1 is flax's 0.9: new = 0.9 old + 0.1 batch."""
    model, params, stats, consts, template = jax_model
    x = _batch(2)[0]
    _, mut = _jax_forward(model, True)({"params": params, "batch_stats": stats,
                                        "constants": consts}, jnp.asarray(x))
    port = _port(params, stats, consts).train()
    with torch.no_grad():
        port(_nchw(x))
    got = _flat(be_from_torch({k: v.numpy() for k, v in port.state_dict().items()}, template)[1])
    want, old = _flat(mut["batch_stats"]), _flat(stats)
    assert sorted(got) == sorted(want) and len(want) == 2 * (6 + 2 * 4)
    for key in want:
        if key[-1] == "mean":
            np.testing.assert_allclose(got[key], want[key], atol=1e-5, rtol=1e-5, err_msg=str(key))
            continue
        n = _bn_elements(key)
        unbiased = (got[key] - 0.9 * old[key]) * (n - 1) / n
        np.testing.assert_allclose(unbiased, want[key] - 0.9 * old[key], atol=1e-5, rtol=1e-4,
                                   err_msg=str(key))
    for m in port.modules():
        if isinstance(m, FrozenBatchNorm2d):
            assert not any(t.requires_grad for t in m.buffers())


@pytest.fixture(scope="module")
def jax_f64_step(jax_model):
    """One step of the JAX package's BE recipe in f64 (steps_be.py:33-61:
    the gradient of both heads' losses with stop_frozen_gradients, then
    frozen_backbone_adam): its losses, gradients, new params and BN stats."""
    model, params, stats, consts, _ = jax_model
    imgs, bimgs, eimgs = _batch(3, np.float64)

    def loss_fn(p, bs, imgs, bimgs, eimgs):
        p = stop_frozen_gradients(p)
        preds, mut = model.apply({"params": p, "batch_stats": bs, "constants": consts64},
                                 imgs, train=True, mutable=["batch_stats"])
        le = JLoss.mask_edge_losses(preds["edges"], eimgs)
        lm = JLoss.mask_edge_losses(preds["masks"], bimgs)
        return le + lm, ({"loss_edge": le, "loss_mask": lm}, mut["batch_stats"])

    with jax.enable_x64(True):
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
        consts64 = cast(consts)
        state = JaxTrainState.create(model.apply, cast(params), cast(stats),
                                     jax_frozen_backbone_adam(LR), constants=consts64)

        @jax.jit
        def step(state, imgs, bimgs, eimgs):
            grads, (m, bs) = jax.grad(loss_fn, has_aux=True)(state.params, state.batch_stats,
                                                              imgs, bimgs, eimgs)
            return state.apply_gradients(grads, new_batch_stats=bs), m, grads

        new_state, m, grads = jax.device_get(step(state, *map(jnp.asarray, (imgs, bimgs, eimgs))))
    return (imgs, bimgs, eimgs), m, _flat(grads), new_state


def _from_torch(sd, template):
    """be_from_torch in x64 mode: its backbone transplant makes jnp arrays,
    which would round f64 values to f32 outside it."""
    with jax.enable_x64(True):
        return tuple(_flat(t) for t in be_from_torch(sd, template))


def _port_grads(port, template):
    """The port's .grad per parameter as the JAX params tree (flattened),
    through be_from_torch; a parameter with no gradient gives None."""
    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    sd.update({k: p.grad.numpy() for k, p in port.named_parameters() if p.grad is not None})
    none = {k for k, p in port.named_parameters() if p.grad is None}
    sd.update({k: np.full(p.shape, np.nan) for k, p in port.named_parameters() if k in none})
    tree = _from_torch(sd, template)[0]
    return {k: (None if np.isnan(v).all() else v) for k, v in tree.items()}


def _frozen_or_unread(key) -> str:
    """Why a JAX gradient is exactly zero: the frozen stem/layer1, or an FPN
    level BE never reads (its 3x3 output conv)."""
    if key[3] == "conv1" or key[3].startswith("layer1_"):
        return "frozen"
    if key[2] == "fpn" and key[3] in ("layer1", "layer2", "layer3"):
        return "unread"
    return ""


def test_f64_gradients_match_jax(jax_model, jax_f64_step):
    """Both losses within 1e-10, and every trainable tensor's gradient in f64
    within 1e-9 of its largest magnitude; the frozen stem and layer1, and
    the 3x3 convs of the FPN levels BE never reads, get no gradient at all
    (JAX's are exactly zero)."""
    _, params, stats, consts, template = jax_model
    (imgs, bimgs, eimgs), jm, want, _ = jax_f64_step
    port = _port(params, stats, consts, torch.float64).train()
    frozen = frozen_backbone_adam(port, LR)  # turns off the stem's and layer1's requires_grad
    m = TS.be_losses(port(_nchw(imgs)), _nchw(bimgs), _nchw(eimgs))
    (m["loss_edge"] + m["loss_mask"]).backward()
    for k in TS.METRIC_KEYS:
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]), rtol=1e-10, err_msg=k)
    got = _port_grads(port, template)
    assert sorted(got) == sorted(want)
    counts = {"frozen": 0, "unread": 0, "": 0}
    for k, w in want.items():
        why = _frozen_or_unread(k) if k[0] == "feature_net" and k[1] == "backbone" else ""
        counts[why] += 1
        if why:
            assert got[k] is None and not np.asarray(w).any(), k
            continue
        scale = np.abs(want[ZERO_GRADS[k]]).max() if k in ZERO_GRADS else np.abs(w).max()
        np.testing.assert_allclose(got[k], w, atol=F64_TOL * scale, rtol=0, err_msg=str(k))
    assert counts["frozen"] == 1 + 4 and counts["unread"] == 6 and counts[""] > 50
    assert frozen.step == 0


def test_one_adam_step_matches_jax_and_frozen_tensors_stay(jax_model, jax_f64_step):
    """One f64 step through make_be_train_step with frozen_backbone_adam
    against the JAX step: every weight within 1e-9 of its largest magnitude
    plus the update's slope at g = 0 (lr / eps = 1e4) times its gradients'
    difference; Adam's moments within 1e-9; the frozen stem and layer1, and
    every FrozenBatchNorm buffer, bit for bit unchanged; BN buffers as the
    JAX step's (running_var with the n / (n - 1) factor taken out): means
    within 1e-10 relative, variances within 1e-8 of their largest."""
    _, params, stats, consts, template = jax_model
    (imgs, bimgs, eimgs), jm, want_g, jstate = jax_f64_step
    port = _port(params, stats, consts, torch.float64).train()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    state = frozen_backbone_adam(port, LR)
    trainable = {id(p) for p in port.parameters() if p.requires_grad}
    assert {id(p) for g in state.optimizer.param_groups for p in g["params"]} == trainable
    state, metrics = TS.make_be_train_step(port)(state, _nchw(imgs), _nchw(bimgs), _nchw(eimgs))
    assert state.step == 1 and sorted(metrics) == sorted(TS.METRIC_KEYS)
    for k in TS.METRIC_KEYS:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), rtol=1e-10, err_msg=k)
    for name, p in port.named_parameters():
        if not p.requires_grad:
            assert p.grad is None and torch.equal(p, before[name]), name
            assert ".body.conv1." in name or ".body.layer1." in name, name
    for name, m in port.named_modules():
        if isinstance(m, FrozenBatchNorm2d):
            for b, t in m.named_buffers():
                assert torch.equal(t, before[f"{name}.{b}"]), (name, b)

    got_g = _port_grads(port, template)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    got_p, got_s, _ = _from_torch(sd, template)
    want_p = _flat(jstate.params)
    for k, w in want_p.items():
        diff = 0.0 if got_g[k] is None else np.abs(got_g[k] - want_g[k])
        bound = F64_TOL * np.abs(w).max() + 1.001 * LR / 1e-8 * diff
        assert (np.abs(got_p[k] - w) <= bound).all(), ("parameter", k)
    names = {id(p): n for n, p in port.named_parameters()}
    inner = jstate.opt_state.inner_states["train"].inner_state[0]
    for moment, opt_key in ((inner.mu, "exp_avg"), (inner.nu, "exp_avg_sq")):
        sd_m = {k: np.zeros(v.shape) for k, v in sd.items()}
        sd_m.update({names[id(p)]: s[opt_key].numpy() for p, s in state.optimizer.state.items()})
        got_m = _from_torch(sd_m, template)[0]
        want_m = _flat(moment)
        for k, w in want_m.items():
            if not isinstance(w, np.ndarray):  # optax's MaskedNode: a frozen tensor
                assert _frozen_or_unread(k) == "frozen" and not got_m[k].any(), k
                continue
            scale = np.abs(want_m[ZERO_GRADS[k]] if k in ZERO_GRADS else w).max()
            np.testing.assert_allclose(got_m[k], w, atol=F64_TOL * scale, rtol=0,
                                       err_msg=f"{opt_key} {k}")
    want_s, old = _flat(jstate.batch_stats), _flat(stats)
    for key, w in want_s.items():
        if key[-1] == "mean":
            np.testing.assert_allclose(got_s[key], w, atol=1e-12, rtol=1e-10, err_msg=str(key))
        else:
            n = _bn_elements(key)  # flax's variance is E[x^2] - E[x]^2, which cancels
            np.testing.assert_allclose((got_s[key] - 0.9 * old[key]) * (n - 1) / n,
                                       w - 0.9 * old[key], atol=1e-8 * np.abs(w).max(), rtol=0,
                                       err_msg=str(key))


@pytest.mark.parametrize("scale", [1.0, 40.0])
def test_mask_edge_losses_match_jax(scale):
    """0.5 x mean BCE-with-logits + dice(sigmoid), value and gradient in
    f64, at moderate and saturated logits (within 1e-12 relative; an
    element's own BCE within 1e-12 of the largest: at |x| = 40 torch's form
    rounds log1p(exp(-40)) away where JAX's keeps it)."""
    rng = np.random.default_rng(int(scale))
    logits = rng.normal(size=(3, 1, 8, 8)) * scale
    targets = (rng.uniform(size=(3, 1, 8, 8)) < 0.3).astype(np.float64)
    with jax.enable_x64(True):
        want, want_g = jax.value_and_grad(JLoss.mask_edge_losses)(jnp.asarray(logits),
                                                                  jnp.asarray(targets))
        want, want_g = float(want), np.asarray(want_g)
    x = torch.from_numpy(logits).requires_grad_()
    got = TLoss.mask_edge_losses(x, torch.from_numpy(targets))
    got.backward()
    np.testing.assert_allclose(float(got), want, rtol=1e-12)
    np.testing.assert_allclose(x.grad.numpy(), want_g, rtol=1e-9, atol=1e-12 * np.abs(want_g).max())
    elem = TLoss.sigmoid_bce_with_logits(torch.from_numpy(logits), torch.from_numpy(targets))
    with jax.enable_x64(True):
        want_e = np.asarray(JLoss.sigmoid_bce_with_logits(jnp.asarray(logits), jnp.asarray(targets)))
    np.testing.assert_allclose(elem.numpy(), want_e, rtol=1e-12, atol=1e-12 * want_e.max())


@pytest.mark.parametrize("normalize", [False, True])
def test_add_coords_matches_jax(normalize):
    """[features, x along W, y along H] on a non-square map."""
    x = np.random.default_rng(0).normal(size=(2, 5, 7, 3)).astype(np.float32)
    want = np.asarray(JL.add_coords(jnp.asarray(x), normalize=normalize))
    got = TL.AddCoords(normalize)(_nchw(x))
    np.testing.assert_allclose(got.numpy(), np.transpose(want, (0, 3, 1, 2)), rtol=0, atol=1e-7)


@pytest.mark.parametrize("bn,train", [(None, True), ("batch", True), ("batch", False),
                                      ("instance", True)])
def test_conv_block_norms_match_jax(bn, train):
    """ConvBlock's three norm paths against flax's, with the JAX block's
    kernel (and BN scale, bias, statistics) carried over: torch's
    BatchNorm2d, InstanceNorm2d (no affine, no statistics) and plain conv."""
    block = JL.ConvBlock(6, 3, bn=bn)
    x = np.random.default_rng(1).normal(size=(2, 9, 9, 4)).astype(np.float32)
    v = jax.device_get(block.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False))
    port = TL.ConvBlock(4, 6, 3, bn=bn)
    p = v["params"]
    sd = {"conv.0.weight": torch.from_numpy(np.transpose(p["conv"]["kernel"], (3, 2, 0, 1)).copy())}
    if bn is None:
        sd["conv.0.bias"] = torch.from_numpy(np.asarray(p["conv"]["bias"]) + 0.1)
        p["conv"]["bias"] = np.asarray(p["conv"]["bias"]) + 0.1
    if bn == "batch":
        rng = np.random.default_rng(2)
        p["norm"] = {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
                     "bias": rng.uniform(-0.5, 0.5, 6).astype(np.float32)}
        v["batch_stats"] = {"norm": {"mean": rng.uniform(-0.5, 0.5, 6).astype(np.float32),
                                     "var": rng.uniform(0.5, 2.0, 6).astype(np.float32)}}
        sd.update({"conv.1.weight": torch.from_numpy(p["norm"]["scale"]),
                   "conv.1.bias": torch.from_numpy(p["norm"]["bias"]),
                   "conv.1.running_mean": torch.from_numpy(v["batch_stats"]["norm"]["mean"]),
                   "conv.1.running_var": torch.from_numpy(v["batch_stats"]["norm"]["var"]),
                   "conv.1.num_batches_tracked": torch.tensor(0)})
    port.load_state_dict(sd)
    out = block.apply(v, jnp.asarray(x), train=train,
                      mutable=["batch_stats"] if bn == "batch" and train else False)
    want = np.asarray(out[0] if isinstance(out, tuple) else out)
    with torch.no_grad():
        got = port.train(train)(_nchw(x))
    np.testing.assert_allclose(got.numpy(), np.transpose(want, (0, 3, 1, 2)), atol=1e-5, rtol=1e-5)


def test_up_matches_jax():
    """Up with coordinates: two BN ConvBlocks (train mode), then the
    bilinear 2x (torch's half-pixel interpolate against jax.image.resize)."""
    up = JL.Up(5, if_add_coord=True)
    x = np.random.default_rng(3).normal(size=(2, 6, 10, 4)).astype(np.float32)
    v = jax.device_get(up.init(jax.random.PRNGKey(3), jnp.asarray(x), train=False))
    want = np.asarray(up.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])[0])
    port = TL.Up(4, 5, if_add_coord=True)
    sd = port.state_dict()
    for j, name in ((0, "conv1"), (1, "conv2")):
        sd[f"conv.{j}.conv.0.weight"] = torch.from_numpy(
            np.transpose(v["params"][name]["conv"]["kernel"], (3, 2, 0, 1)).copy())
    port.load_state_dict(sd)
    with torch.no_grad():
        got = port.train()(_nchw(x))
    assert got.shape == (2, 5, 12, 20)
    np.testing.assert_allclose(got.numpy(), np.transpose(want, (0, 3, 1, 2)), atol=1e-5, rtol=1e-5)


def test_seeded_init():
    """The same weights for a seed; Kaiming-uniform conv weights, zero conv
    biases, BatchNorms at ones and zeros, FrozenBatchNorms at identity (the
    JAX init's families and bounds)."""
    a = TBE.ComposeNet(SLIM, WIDTH, generator=torch.Generator().manual_seed(4))
    b = TBE.ComposeNet(SLIM, WIDTH, generator=torch.Generator().manual_seed(4))
    for (name, t), u in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(t, u), name
    w = a.mask_net.conv1.conv[0].conv[0].weight.detach()
    bound = (6.0 / (34 * 9)) ** 0.5
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
    assert not a.edge_net.predictor[2].conv[0].bias.any()
    bn = a.feature_net.aux_convs[3].conv[1]
    assert bool((bn.weight == 1).all()) and not bn.bias.any()
    assert sum(isinstance(m, torch.nn.BatchNorm2d) for m in a.modules()) == 6 + 2 * 4
