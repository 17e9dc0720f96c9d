"""The port's BE_GAN step (vaeplay_torch.train.steps_be_gan) against the JAX
package's, on the CPU at a small size (G with the (1, 1, 1, 1) x 16
backbone, D at 128 px, batch 2): one D phase and then one G phase of the
JAX recipe in f64 (the seven losses, both nets' gradients, updated weights
and BatchNorm buffers), one step against make_be_gan_train_step itself in
f32, the frozen stem, D held in the G phase, bf16, and the GanState
checkpoint round trip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from torch import nn

from vaeplay_torch.data.be_data import render_bubble_batch, sample_bubble_params
from vaeplay_torch.models import be_gan as TG
from vaeplay_torch.models.convert import (be_gan_disc_state_dict_from_jax,
                                          be_gan_state_dict_from_jax)
from vaeplay_torch.train.checkpoint import Checkpointer, restore_state, save_state
from vaeplay_torch.train.state import GanState, TrainState, frozen_backbone_adam
from vaeplay_torch.train.steps_be_gan import D_KEYS, G_KEYS, METRIC_KEYS, make_be_gan_train_step
from vaeplay_tpu.models.be_gan import ComposeNet, Discriminator
from vaeplay_tpu.models.torch_convert import be_gan_disc_from_torch, be_gan_from_torch
from vaeplay_tpu.ops import losses as JLoss
from vaeplay_tpu.train.state import TrainState as JaxTrainState
from vaeplay_tpu.train.state import frozen_backbone_adam as jax_frozen_backbone_adam
from vaeplay_tpu.train.state import stop_frozen_gradients, torch_adam
from vaeplay_tpu.train.steps_be_gan import GanState as JaxGanState
from vaeplay_tpu.train.steps_be_gan import make_be_gan_train_step as jax_step

SLIM, WIDTH, IMG, B, LR = (1, 1, 1, 1), 16, 128, 2, 1e-4
BETAS = (0.5, 0.999)
F64_TOL = 1e-9  # f64 gradients and weights: of each tensor's largest magnitude
TRAJ_RTOL = 2e-5  # f32 losses against the JAX step (tests/test_torch_train_be.py's bound)
# fpn.layer_blocks.0 meets aux_convs.0, a 1x1 conv and a train-mode
# BatchNorm, which takes out any per-channel constant: its bias's true
# gradient is 0, so it is held to its layer's weight gradient's scale
ZERO_GRADS = {("backbone", "fpn", "layer0", "bias"): ("backbone", "fpn", "layer0", "kernel")}


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Two torch threads a process: the suite runs in several worker
    processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_init():
    """Both JAX nets' init, G's FrozenBatchNorm constants drawn (scale in
    [0.3, 0.8], bias and mean in +-0.1, var in [0.5, 1.5])."""
    g, d = ComposeNet(backbone_layers=SLIM, backbone_width=WIDTH), Discriminator(in_size=IMG)
    x, m = jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1, IMG, IMG, 1))
    gv = jax.device_get(jax.jit(g.init)({"params": jax.random.PRNGKey(3)}, x))
    dv = jax.device_get(jax.jit(d.init)({"params": jax.random.PRNGKey(4)}, x, m, m))
    rng = np.random.default_rng(3)
    consts = traverse_util.flatten_dict(gv["constants"])
    ranges = {"scale": (0.3, 0.8), "bias": (-0.1, 0.1), "mean": (-0.1, 0.1), "var": (0.5, 1.5)}
    for k in consts:
        consts[k] = rng.uniform(*ranges[k[-1]], consts[k].shape).astype(np.float32)
    gv = {**gv, "constants": traverse_util.unflatten_dict(consts)}
    return g, d, gv, dv


def _batch(seed, dtype=np.float64):
    """Noise images (no exact zeros at the ReLUs), bubble masks and labels,
    NCHW torch tensors."""
    imgs = np.random.default_rng(seed).uniform(size=(B, 3, IMG, IMG)).astype(dtype)
    table, labels = sample_bubble_params(IMG, B, seed=seed)
    _, bimgs, eimgs = render_bubble_batch(IMG, torch.from_numpy(table))
    to = torch.float64 if dtype == np.float64 else torch.float32
    return (torch.from_numpy(imgs), bimgs.to(to), eimgs.to(to), torch.from_numpy(labels))


def _nhwc(t: torch.Tensor):
    return jnp.asarray(t.permute(0, 2, 3, 1).numpy()) if t.dim() == 4 else jnp.asarray(t.numpy())


def _port_state(jax_init, dtype=torch.float64) -> GanState:
    _, _, gv, dv = jax_init
    g, d = TG.ComposeNet(SLIM, WIDTH), TG.Discriminator(IMG)
    g.load_state_dict(be_gan_state_dict_from_jax(gv["params"], gv["batch_stats"], gv["constants"]))
    d.load_state_dict(be_gan_disc_state_dict_from_jax(dv["params"], dv["batch_stats"]))
    g, d = g.to(dtype).train(), d.to(dtype).train()
    return GanState(frozen_backbone_adam(g, LR, BETAS), TrainState.create(d, LR * 0.1, betas=BETAS))


def _jax_phases(g, d):
    """The JAX package's BE_GAN recipe (steps_be_gan.py:82-138) composed from
    its models, losses and stop_frozen_gradients, without the step's casts
    of every output and batch statistic to f32 (amp.to_f32), which would
    round an f64 step: (d_phase, g_phase), each jitted, as the JAX step
    exposes them."""
    def g_apply(gst, params, bs, imgs):
        out, mut = g.apply({"params": stop_frozen_gradients(params), "batch_stats": bs,
                            "constants": gst.constants}, imgs, train=True,
                           mutable=["batch_stats"])
        return out, mut["batch_stats"]

    def d_apply(params, bs, imgs, m1, m2):
        out, mut = d.apply({"params": params, "batch_stats": bs}, imgs, m1, m2, train=True,
                           mutable=["batch_stats"])
        return out, mut["batch_stats"]

    @jax.jit
    def d_phase(gs, imgs, bimgs, eimgs, labels):
        preds, g_bs = g_apply(gs.g, gs.g.params, gs.g.batch_stats, imgs)
        pm, pe = jax.nn.sigmoid(preds["masks"]), jax.nn.sigmoid(preds["edges"])

        def loss_fn(p, bs):
            (real_type, real_feats), bs = d_apply(p, bs, imgs, bimgs, eimgs)
            (_, fake_feats), bs = d_apply(p, bs, imgs, pm, pe)
            adv = 1.0 - jnp.mean(jnp.abs(fake_feats - real_feats))
            typ = jnp.mean(JLoss.softmax_cross_entropy(real_type, labels))
            return adv + typ, ({"d_adv_loss": adv, "d_type_loss": typ}, bs)

        grads, (m, d_bs) = jax.grad(loss_fn, has_aux=True)(gs.d.params, gs.d.batch_stats)
        return JaxGanState(g=gs.g.replace(batch_stats=g_bs),
                           d=gs.d.apply_gradients(grads, new_batch_stats=d_bs)), m

    @jax.jit
    def g_phase(gs, imgs, bimgs, eimgs, labels):
        def loss_fn(p, g_bs, d_bs):
            preds, g_bs = g_apply(gs.g, p, g_bs, imgs)
            pm, pe = preds["masks"], preds["edges"]
            (_, real_feats), d_bs = d_apply(gs.d.params, d_bs, imgs, bimgs, eimgs)
            real_feats = jax.lax.stop_gradient(real_feats)
            (fake_type, fake_feats), d_bs = d_apply(gs.d.params, d_bs, imgs,
                                                    jax.nn.sigmoid(pm), jax.nn.sigmoid(pe))
            m = {"loss_mask": JLoss.mask_edge_losses(pm, bimgs),
                 "loss_edge": JLoss.mask_edge_losses(pe, eimgs),
                 "g_adv_loss": jnp.mean(jnp.abs(fake_feats - real_feats)),
                 "g_type_loss": jnp.mean(JLoss.softmax_cross_entropy(fake_type, labels)),
                 "loss_cnt": (JLoss.edge_loss(jax.nn.sigmoid(pm), bimgs)
                              + JLoss.edge_loss(jax.nn.sigmoid(pe), eimgs))}
            total = (m["loss_mask"] * 2 + m["loss_edge"] * 2 + m["g_adv_loss"]
                     + m["g_type_loss"] + m["loss_cnt"] * 0.5)
            return total, (m, g_bs, d_bs)

        grads, (m, g_bs, d_bs) = jax.grad(loss_fn, has_aux=True)(
            gs.g.params, gs.g.batch_stats, gs.d.batch_stats)
        return JaxGanState(g=gs.g.apply_gradients(grads, new_batch_stats=g_bs),
                           d=gs.d.replace(batch_stats=d_bs)), m

    return d_phase, g_phase


def _jax_state(jax_init, cast=lambda t: t) -> JaxGanState:
    g, d, gv, dv = jax_init
    return JaxGanState(
        g=JaxTrainState.create(g.apply, cast(gv["params"]), cast(gv["batch_stats"]),
                               jax_frozen_backbone_adam(LR, BETAS), constants=cast(gv["constants"])),
        d=JaxTrainState.create(d.apply, cast(dv["params"]), cast(dv["batch_stats"]),
                               torch_adam(LR * 0.1, BETAS)))


@pytest.fixture(scope="module")
def jax_f64_phases(jax_init):
    """The JAX recipe's D phase, then its G phase, in f64 from jax_init: the
    metrics and the state after each."""
    batch = _batch(5)
    with jax.enable_x64(True):
        gs = _jax_state(jax_init, lambda t: jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), t))
        d_phase, g_phase = _jax_phases(*jax_init[:2])
        args = [_nhwc(t) for t in batch]
        gs1, dm = jax.device_get(d_phase(gs, *args))
        gs2, gm = jax.device_get(g_phase(gs1, *args))
    return batch, (gs1, dm), (gs2, gm)


class BiasedRunningVar:
    """torch updates running_var with the unbiased batch variance, flax with
    the biased one (ROADMAP queue 3). Forward pre-hooks on every train-mode
    BatchNorm2d accumulate, with the norm's momentum, the difference var /
    (n - 1) of each update, so that running_var - corr[name] is flax's."""

    def __init__(self, model: nn.Module):
        self.corr = {}
        for name, m in model.named_modules():
            if isinstance(m, nn.BatchNorm2d):
                self.corr[name] = torch.zeros_like(m.running_var)
                m.register_forward_pre_hook(self._hook(name))

    def _hook(self, name):
        def hook(m, inputs):
            if m.training:
                x = inputs[0].detach()
                n = x.numel() // x.shape[1]
                var = x.var(dim=(0, 2, 3), unbiased=False)
                self.corr[name] = (1 - m.momentum) * self.corr[name] + m.momentum * var / (n - 1)
        return hook

    def state_dict(self, model: nn.Module):
        sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
        for name, c in self.corr.items():
            sd[f"{name}.running_var"] = sd[f"{name}.running_var"] - c.numpy()
        return sd


def _g_trees(sd, template):
    """A G state_dict as the JAX (params, batch_stats) trees, flattened; in
    x64 mode, as be_gan_from_torch's backbone transplant makes jnp arrays."""
    with jax.enable_x64(True):
        return tuple(traverse_util.flatten_dict(jax.device_get(t))
                     for t in be_gan_from_torch(sd, template)[:2])


def _d_trees(sd):
    return tuple(traverse_util.flatten_dict(t) for t in be_gan_disc_from_torch(sd))


def _grads(model: nn.Module, to_trees):
    """The port's .grad per parameter as the JAX params tree (flattened); a
    parameter with no gradient gives None."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    for k, p in model.named_parameters():
        sd[k] = p.grad.numpy() if p.grad is not None else np.full(p.shape, np.nan)
    return {k: (None if np.isnan(v).all() else v) for k, v in to_trees(sd)[0].items()}


def _adam_grads(mu) -> dict:
    """A one-step optax Adam's gradients: mu = (1 - b1) g = g / 2."""
    return {k: (v / (1 - BETAS[0]) if isinstance(v, np.ndarray) else None)
            for k, v in traverse_util.flatten_dict(jax.device_get(mu)).items()}


def _check_phase(port_model, want_state, want_g, tracker, to_trees, lr):
    """Gradients, weights (within F64_TOL of their largest plus Adam's slope
    at g = 0, lr / eps, times the gradients' difference) and BN buffers
    (means within 1e-10 relative, flax's variances within 1e-8 of their
    largest) against the JAX phase's."""
    got_g = _grads(port_model, to_trees)
    assert sorted(got_g) == sorted(want_g)
    for k, w in want_g.items():
        if w is None or not np.asarray(w).any():  # frozen, or an FPN level G never reads
            assert got_g[k] is None, k
            continue
        scale = np.abs(want_g[ZERO_GRADS[k]] if k in ZERO_GRADS else w).max()
        np.testing.assert_allclose(got_g[k], w, atol=F64_TOL * scale, rtol=0, err_msg=str(k))
    got_p, got_s = to_trees(tracker.state_dict(port_model))
    for k, w in traverse_util.flatten_dict(want_state.params).items():
        w = np.asarray(w)
        diff = 0.0 if got_g[k] is None else np.abs(got_g[k] - want_g[k])
        bound = F64_TOL * np.abs(w).max() + 1.001 * lr / 1e-8 * diff
        assert (np.abs(got_p[k] - w) <= bound).all(), ("parameter", k)
    for k, w in traverse_util.flatten_dict(want_state.batch_stats).items():
        w = np.asarray(w)
        if k[-1] == "mean":
            np.testing.assert_allclose(got_s[k], w, atol=1e-12, rtol=1e-10, err_msg=str(k))
        else:
            np.testing.assert_allclose(got_s[k], w, atol=1e-8 * np.abs(w).max(), rtol=0,
                                       err_msg=str(k))


def test_f64_d_phase_then_g_phase_match_jax(jax_init, jax_f64_phases):
    """One D phase: its two losses within 1e-10 relative; D's gradients,
    Adam step and BN buffers (two updates: real, then fake), and G's BN
    buffers (one no-gradient train-mode forward) as JAX's. Then one G phase
    against the updated D: its five losses; G's gradients (none for the
    frozen stem and layer1) and Adam step; both nets' BN buffers."""
    batch, (jd_state, jdm), (jg_state, jgm) = jax_f64_phases
    gs = _port_state(jax_init)
    tg, td = BiasedRunningVar(gs.g.model), BiasedRunningVar(gs.d.model)
    step = make_be_gan_train_step(gs.g.model, gs.d.model)
    template = jax_init[2]

    gs, dm = step.d_phase(gs, *batch)
    assert sorted(dm) == sorted(D_KEYS) and gs.d.step == 1 and gs.g.step == 0
    for k in D_KEYS:
        np.testing.assert_allclose(float(dm[k]), float(jdm[k]), rtol=1e-10, err_msg=k)
    _check_phase(gs.d.model, jd_state.d, _adam_grads(jd_state.d.opt_state[0].mu), td, _d_trees,
                 LR * 0.1)
    g_stats = _g_trees(tg.state_dict(gs.g.model), template)[1]
    for k, w in traverse_util.flatten_dict(jd_state.g.batch_stats).items():
        np.testing.assert_allclose(g_stats[k], w, atol=1e-8 * np.abs(w).max(), rtol=1e-10,
                                   err_msg=str(k))

    gs, gm = step.g_phase(gs, *batch)
    assert sorted(gm) == sorted(G_KEYS) and gs.g.step == 1
    for k in G_KEYS:
        np.testing.assert_allclose(float(gm[k]), float(jgm[k]), rtol=1e-10, err_msg=k)
    inner = jg_state.g.opt_state.inner_states["train"].inner_state[0]
    _check_phase(gs.g.model, jg_state.g, _adam_grads(inner.mu), tg,
                 lambda sd: _g_trees(sd, template), LR)
    d_stats = _d_trees(td.state_dict(gs.d.model))[1]
    for k, w in traverse_util.flatten_dict(jg_state.d.batch_stats).items():
        np.testing.assert_allclose(d_stats[k], w, atol=1e-8 * np.abs(w).max(), rtol=1e-10,
                                   err_msg=str(k))


def test_f32_step_tracks_jax_step(jax_init):
    """One f32 step against the JAX package's make_be_gan_train_step (with its
    f32 casts) from the same weights and batch: the seven losses within
    TRAJ_RTOL. The G phase runs against a D that Adam moved by about lr x
    0.1 x sign(g) a weight, so a rounding-sized D gradient whose sign
    differs moves a weight by up to 2e-5 between the frameworks."""
    batch = _batch(9, np.float32)
    gs = _port_state(jax_init, torch.float32)
    _, got = make_be_gan_train_step(gs.g.model, gs.d.model)(gs, *batch)
    _, want = jax_step(*jax_init[:2])(_jax_state(jax_init), *[_nhwc(t) for t in batch])
    for k in METRIC_KEYS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=TRAJ_RTOL, err_msg=k)


def test_g_phase_holds_d_and_the_frozen_stem(jax_init):
    """The G phase leaves D's weights and the D phase's gradients in D's
    .grad as they were, and computes no gradient for the frozen stem and
    layer1, which no phase moves."""
    gs = _port_state(jax_init, torch.float32)
    step = make_be_gan_train_step(gs.g.model, gs.d.model)
    before = {k: v.clone() for k, v in gs.g.model.state_dict().items()}
    batch = _batch(6, np.float32)
    gs, _ = step.d_phase(gs, *batch)
    d_weights = {k: v.clone() for k, v in gs.d.model.state_dict().items()}
    d_grads = {k: p.grad.clone() for k, p in gs.d.model.named_parameters()}
    gs, _ = step.g_phase(gs, *batch)
    for k, p in gs.d.model.named_parameters():
        assert torch.equal(p, d_weights[k]) and torch.equal(p.grad, d_grads[k]), k
    for k, p in gs.g.model.named_parameters():
        if ".body.conv1." in k or ".body.layer1." in k:
            assert not p.requires_grad and p.grad is None and torch.equal(p, before[k]), k
    assert not torch.equal(gs.g.model.mask_net.predictor[2].conv[0].bias,
                           before["mask_net.predictor.2.conv.0.bias"])
    assert gs.g.optimizer.param_groups[0]["betas"] == BETAS == gs.d.optimizer.param_groups[0]["betas"]
    assert gs.d.optimizer.param_groups[0]["lr"] == LR * 0.1


def test_bf16_step_keeps_f32_state(jax_init):
    """Under bf16 autocast the seven losses are finite and near the f32
    step's (within 5%, tests/test_bf16.py's budget); parameters, gradients,
    Adam's moments and every buffer stay f32."""
    batch = _batch(7, np.float32)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        gs = _port_state(jax_init, torch.float32)
        gs, m = make_be_gan_train_step(gs.g.model, gs.d.model, dtype)(gs, *batch)
        out[dtype] = {k: float(v) for k, v in m.items()}
    for k in METRIC_KEYS:
        f32, bf16 = out[torch.float32][k], out[torch.bfloat16][k]
        assert np.isfinite(bf16) and abs(bf16 - f32) < 0.05 * abs(f32), (k, f32, bf16)
    assert out[torch.float32] != out[torch.bfloat16]
    for state in (gs.g, gs.d):
        for name, t in state.model.state_dict().items():
            assert not t.is_floating_point() or t.dtype == torch.float32, name
        for s in state.optimizer.state.values():
            assert s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32


def test_gan_state_round_trip_and_resume(jax_init, tmp_path):
    """A GanState saved after a step restores whole (both models, both
    optimizers, both step counts) into a fresh one, and the next step equals
    a run that never stopped."""
    batches = [_batch(8 + i, np.float32) for i in range(2)]
    gs = _port_state(jax_init, torch.float32)
    step = make_be_gan_train_step(gs.g.model, gs.d.model)
    gs, _ = step(gs, *batches[0])
    save_state(Checkpointer(str(tmp_path)), 0, gs)
    _, straight = step(gs, *batches[1])
    fresh = _port_state(jax_init, torch.float32)
    resumed, tag = restore_state(str(tmp_path), fresh)
    assert tag == 0 and resumed.g.step == resumed.d.step == 1
    assert sorted(torch.load(tmp_path / "0.ckpt", weights_only=True)) == ["d", "g"]
    _, m = make_be_gan_train_step(resumed.g.model, resumed.d.model)(resumed, *batches[1])
    assert {k: float(v) for k, v in m.items()} == {k: float(v) for k, v in straight.items()}
