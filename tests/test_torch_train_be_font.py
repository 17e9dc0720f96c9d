"""The port's BE_font step (vaeplay_torch.train.steps_be_font) against the
JAX package's, on the CPU at 32 px (G slim, max_channel 64; D at
its fixed widths; batch 3): the D, G and S phases of the JAX recipe in f64 (their
losses, every gradient, the weights after each optimizer's step and the
BatchNorm buffers), three f32 steps against make_be_font_train_step
itself, what each phase leaves alone, bf16 against f32, and the FontState
checkpoint round trip.

The JAX step casts outputs and batch statistics to f32 even under x64
(amp.to_f32), so the f64 test composes its recipe from the JAX models,
losses, TrainState and style-only optimizer, with f64 attention. Every
attention block sees one position: q and k get a gradient of exactly 0 on
both sides (the softmax over one key is constant), and are held there."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_be_font import IMG, f64_attention, init_nets, port_d, port_g
from test_torch_train_be_gan import BiasedRunningVar
from vaeplay_torch.data.font_data import SyntheticGlyphDataset
from vaeplay_torch.models.convert import (be_font_disc_state_dict_from_jax,
                                          be_font_state_dict_from_jax)
from vaeplay_torch.train.checkpoint import Checkpointer, restore_state, save_state
from vaeplay_torch.train.state import FontState
from vaeplay_torch.train.steps_be_font import (D_KEYS, G_KEYS, METRIC_KEYS, S_KEYS,
                                               make_be_font_train_step)
from vaeplay_tpu.core import layers as JL
from vaeplay_tpu.ops import losses as JLoss
from vaeplay_tpu.train.steps_be_font import create_font_state, style_only_tx
from vaeplay_tpu.train.steps_be_font import make_be_font_train_step as jax_step

# batch 3: at 32 px D's last BatchNorm (backbone.3) sees a 1 x 1 map, so it
# normalizes over B values; over 2 its outputs are +-1 whatever its input,
# and every gradient through it is rounding
B, LR = 3, 1e-4
F64_TOL = 1e-9  # f64 gradients and weights: of each tensor's largest magnitude
F32_TOL = 1e-3  # three f32 steps: the losses, relative
# bf16 losses against f32 (tests/test_bf16.py's budget); loss_embed is the
# L1 between two bf16 forwards' logits, each about 4 times larger than their
# difference, so bf16's 2^-8 rounding of each is several percent of it
BF16_BUDGET = {k: 0.05 for k in METRIC_KEYS} | {"loss_embed": 0.15}


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    return init_nets(seed=4)


def _batch(seed, dtype=np.float64):
    """Noise images, noise mask and edge targets in [0, 1], labels, styles
    (NHWC numpy)."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(B, IMG, IMG, 3)).astype(dtype),
            rng.uniform(size=(B, IMG, IMG, 1)).astype(dtype),
            rng.uniform(size=(B, IMG, IMG, 1)).astype(dtype),
            rng.integers(0, 143, B), rng.normal(size=(B, 5)).astype(dtype))


def _torch_batch(batch, dtype):
    imgs, masks, edges, labels, styles = batch
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2)))).to(dtype)
    return (nchw(imgs), nchw(masks), nchw(edges), torch.from_numpy(labels),
            torch.from_numpy(styles).to(dtype))


def _port_state(nets, dtype) -> FontState:
    _, _, gv, dv = nets
    return FontState.create(port_g(gv, dtype).train(), port_d(dv, dtype).train(), LR)


def _jax_phases(g, d):
    """The JAX BE_font recipe (steps_be_font.py:84-159) composed from its
    models, losses, TrainState and style-only optimizer without the step's
    f32 casts: (d_phase, g_phase, s_phase), each (font_state, imgs, masks,
    edges, labels, styles) -> (font_state, metrics, gradients), jitted."""
    s_tx = style_only_tx(LR)

    def g_apply(p, bs, imgs, y):
        out, mut = g.apply({"params": p, "batch_stats": bs}, imgs, y=y, train=True,
                           mutable=["batch_stats"])
        return out, mut["batch_stats"]

    def d_apply(p, bs, x, y):
        out, mut = d.apply({"params": p, "batch_stats": bs}, x, y, train=True,
                           mutable=["batch_stats"])
        return out, mut["batch_stats"]

    def cond(labels, styles):
        return {"cls": jax.nn.one_hot(labels, 143, dtype=styles.dtype), "cnt_style": styles}

    @jax.jit
    def d_phase(fs, imgs, masks, edges, labels, styles):
        y = cond(labels, styles)
        preds, g_bs = g_apply(fs.g.params, fs.g.batch_stats, imgs, y)
        fake = jax.lax.stop_gradient(jnp.concatenate([preds["masks"], preds["edges"]], -1))

        def loss(p, bs):
            (gt_adv, gt_aux), bs = d_apply(p, bs, jnp.concatenate([masks, edges], -1), y)
            (pd_adv, _), bs = d_apply(p, bs, fake, y)
            m = {"d_adv_real": jnp.mean(JLoss.bce(gt_adv, jnp.ones_like(gt_adv))),
                 "d_aux_real": jnp.mean(JLoss.softmax_cross_entropy(gt_aux, labels)),
                 "d_adv_fake": jnp.mean(JLoss.bce(pd_adv, jnp.zeros_like(pd_adv)))}
            return (m["d_adv_real"] + m["d_adv_fake"]) * 0.5 + m["d_aux_real"], (m, bs)

        grads, (m, d_bs) = jax.grad(loss, has_aux=True)(fs.d.params, fs.d.batch_stats)
        return fs.replace(g=fs.g.replace(batch_stats=g_bs),
                          d=fs.d.apply_gradients(grads, new_batch_stats=d_bs)), m, grads

    @jax.jit
    def g_phase(fs, imgs, masks, edges, labels, styles):
        y = cond(labels, styles)

        def loss(p, g_bs, d_bs):
            preds, g_bs = g_apply(p, g_bs, imgs, y)
            pm, pe = preds["masks"], preds["edges"]
            (adv, aux), d_bs = d_apply(fs.d.params, d_bs, jnp.concatenate([pm, pe], -1), y)
            m = {"loss_mask": JLoss.mask_edge_losses(pm, masks) * 10.0,
                 "loss_edge": JLoss.mask_edge_losses(pe, edges) * 10.0,
                 "loss_g_adv": jnp.mean(JLoss.bce(adv, jnp.ones_like(adv))) * 2.0,
                 "g_aux_ce": jnp.mean(JLoss.softmax_cross_entropy(aux, labels))}
            m["loss_g_aux"] = m["loss_g_adv"] * 5.0
            total = m["loss_edge"] + m["loss_mask"] + m["loss_g_adv"] + m["loss_g_aux"]
            return total, (m, g_bs, d_bs)

        grads, (m, g_bs, d_bs) = jax.grad(loss, has_aux=True)(
            fs.g.params, fs.g.batch_stats, fs.d.batch_stats)
        return fs.replace(g=fs.g.apply_gradients(grads, new_batch_stats=g_bs),
                          d=fs.d.replace(batch_stats=d_bs)), m, grads

    @jax.jit
    def s_phase(fs, imgs, masks, edges, labels, styles):
        ref, g_bs = g_apply(fs.g.params, fs.g.batch_stats, imgs, cond(labels, styles))
        ref = jax.lax.stop_gradient(ref)

        def loss(p, bs):
            preds, bs = g_apply(p, bs, imgs, None)
            pm, pe = preds["masks"], preds["edges"]
            m = {"loss_embed": (jnp.mean(jnp.abs(pm - ref["masks"]))
                                + jnp.mean(jnp.abs(pe - ref["edges"]))) * 2.0}
            total = (JLoss.mask_edge_losses(pm, masks) + JLoss.mask_edge_losses(pe, edges)
                     + m["loss_embed"])
            return total, (m, bs)

        grads, (m, bs) = jax.grad(loss, has_aux=True)(fs.g.params, g_bs)
        updates, s_state = s_tx.update(grads, fs.style_opt_state, fs.g.params)
        return fs.replace(g=fs.g.replace(params=optax.apply_updates(fs.g.params, updates),
                                         batch_stats=bs),
                          style_opt_state=s_state), m, grads

    return d_phase, g_phase, s_phase


@pytest.fixture(scope="module")
def jax_f64_phases(nets):
    """The JAX recipe's D, G and S phases in turn, f64, from nets: after each
    the state, the metrics and the gradients (numpy)."""
    g, d, gv, dv = nets
    batch = _batch(5)
    saved = JL.spatial_self_attention
    JL.spatial_self_attention = f64_attention
    try:
        with jax.enable_x64(True):
            c64 = lambda t: jax.tree_util.tree_map(
                lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
            fs = create_font_state(g, d, c64(gv), c64(dv), LR)
            args = [jnp.asarray(a) for a in batch]
            out = []
            for phase in _jax_phases(g, d):
                fs, m, grads = phase(fs, *args)
                out.append(jax.device_get((fs, m, grads)))
    finally:
        JL.spatial_self_attention = saved
    return batch, out


def _zero_exact(name: str) -> bool:
    """An attention block's q and k: a gradient of exactly 0 at N = 1."""
    return ".attention." in name and (".q." in name or ".k." in name)


def _check_grads(model, want_sd, names=None):
    """Each parameter's .grad within F64_TOL of the JAX gradient's largest
    magnitude; the attention q and k at exactly 0 on both sides; `names`:
    the parameters that must have a gradient (the rest must have none)."""
    for name, p in model.named_parameters():
        w = want_sd[name].numpy()
        if names is not None and name not in names:
            assert p.grad is None and not w.any(), name
            continue
        assert p.grad is not None and p.grad.dtype == torch.float64, name
        if _zero_exact(name):
            assert not p.grad.any() and not w.any(), name
            continue
        scale = np.abs(w).max()
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), w, atol=F64_TOL * scale, rtol=0, err_msg=name)


def _check_state(tracker, model, want_sd, want_grads=None):
    """Weights within F64_TOL of their largest plus Adam's slope at g = 0
    (lr / eps) times the two gradients' difference (want_grads: the JAX
    gradients of the step that last moved each weight, against the port's
    .grad); BatchNorm means within 1e-10 relative, flax's variances within
    F64_TOL of their largest."""
    got = tracker.state_dict(model)
    params = dict(model.named_parameters())
    for k, w in want_sd.items():
        w = w.numpy()
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith("running_mean"):
            np.testing.assert_allclose(got[k], w, atol=1e-12, rtol=1e-10, err_msg=k)
            continue
        bound = F64_TOL * np.abs(w).max()
        if want_grads is not None and k in want_grads and k in params and params[k].grad is not None:
            bound = bound + 1.001 * LR / 1e-8 * np.abs(params[k].grad.numpy()
                                                      - want_grads[k].numpy())
        assert (np.abs(got[k] - w) <= bound).all(), k


def test_f64_three_phases_match_jax(nets, jax_f64_phases):
    """The D phase: its three losses within 1e-10 relative, D's every
    gradient, its Adam step and BN buffers (two updates), G's BN buffers (one
    no-grad train-mode forward). The G phase: its five losses, G's every
    gradient (none for the style encoder), its Adam step, both nets' BN
    buffers. The S phase, both sides from JAX's G after the G phase:
    loss_embed, the style encoder's gradients and its second Adam's step,
    G's BN buffers (two more updates), and every other G weight unmoved."""
    batch, ((fs_d, jdm, jdg), (fs_g, jgm, jgg), (fs_s, jsm, jsg)) = jax_f64_phases
    fs = _port_state(nets, torch.float64)
    tg, td = BiasedRunningVar(fs.g.model), BiasedRunningVar(fs.d.model)
    step = make_be_font_train_step(fs.g.model, fs.d.model)
    tb = _torch_batch(batch, torch.float64)
    g_sd = lambda jfs: be_font_state_dict_from_jax(jfs.g.params, jfs.g.batch_stats)
    d_sd = lambda jfs: be_font_disc_state_dict_from_jax(jfs.d.params, jfs.d.batch_stats)
    style = {f"style_encoder.{n}" for n, _ in fs.g.model.style_encoder.named_parameters()}
    others = {n for n, _ in fs.g.model.named_parameters()} - style

    fs, dm = step.d_phase(fs, *tb)
    assert sorted(dm) == sorted(D_KEYS) and fs.d.step == 1 and fs.g.step == 0
    for k in D_KEYS:
        np.testing.assert_allclose(float(dm[k]), float(jdm[k]), rtol=1e-10, err_msg=k)
    jdg = be_font_disc_state_dict_from_jax(jdg, fs_d.d.batch_stats)
    _check_grads(fs.d.model, jdg)
    _check_state(td, fs.d.model, d_sd(fs_d), jdg)
    _check_state(tg, fs.g.model, g_sd(fs_d))

    fs, gm = step.g_phase(fs, *tb)
    assert sorted(gm) == sorted(G_KEYS) and fs.g.step == 1 and fs.style.step == 0
    for k in G_KEYS:
        np.testing.assert_allclose(float(gm[k]), float(jgm[k]), rtol=1e-10, err_msg=k)
    jgg = be_font_state_dict_from_jax(jgg, fs_g.g.batch_stats)
    _check_grads(fs.g.model, jgg, others)
    _check_state(tg, fs.g.model, g_sd(fs_g), jgg)
    _check_state(td, fs.d.model, d_sd(fs_g), jdg)  # D's .grad: the D phase's

    # both S phases from JAX's G after the G phase: G's Adam amplifies a
    # gradient's rounding near g = 0 by lr / eps, which the S phase's
    # gradients would inherit
    fs.g.model.load_state_dict(g_sd(fs_g))
    tg = BiasedRunningVar(fs.g.model)
    g_weights = {k: v.clone() for k, v in fs.g.model.state_dict().items()}
    fs, sm = step.s_phase(fs, *tb)
    assert sorted(sm) == sorted(S_KEYS) and fs.style.step == 1 and fs.g.step == 1
    np.testing.assert_allclose(float(sm["loss_embed"]), float(jsm["loss_embed"]), rtol=1e-10)
    want = be_font_state_dict_from_jax(jsg, fs_s.g.batch_stats)
    style_grads = {k: v for k, v in want.items() if k.startswith("style_encoder.")}
    for name, p in fs.g.model.style_encoder.named_parameters():
        w = want[f"style_encoder.{name}"].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, atol=F64_TOL * np.abs(w).max(), rtol=0,
                                   err_msg=name)
    _check_state(tg, fs.g.model, g_sd(fs_s), style_grads)
    for name in others:
        assert torch.equal(fs.g.model.get_parameter(name), g_weights[name]), name


def test_f32_steps_track_jax_step(nets):
    """Three f32 steps of the JAX package's make_be_font_train_step and of
    the port's from the same weights on the same synthetic batches, beside
    three f64 steps of the port (whose phases equal JAX's, above).

    Until G's first Adam step (step 0's D- and G-phase metrics) the port's
    f32 metrics are within F32_TOL of JAX's. From there on (the S phase's
    loss_embed, then every later metric) both frameworks' f32 runs leave the
    f64 one by more than that: Adam moves each weight by about lr x sign(g)
    whatever |g| is, so a gradient whose sign f32 rounding decides moves its
    weight by lr either way, and flax's f32 instance norm takes its variance
    as E[x^2] - E[x]^2. There each port metric is held no farther from the
    f64 run than twice JAX's f32 metric is, plus F32_TOL. After the three
    steps every weight is within 2 lr a step (Adam's sign flips) of the f64
    run's and of JAX's, the attention q and k unmoved on all three, and the
    BatchNorm buffers (4 G and 3 D updates a step, through the diverged
    weights) each no farther, in norm, from the f64 run's than twice JAX's,
    plus 1e-3 of theirs."""
    g, d, gv, dv = nets
    batches = [[b[k] for k in ("imgs", "masks", "edges", "labels", "styles")]
               for b in SyntheticGlyphDataset(data_size=3 * B, seed=1).batches(B, IMG)]
    start = _port_state(nets, torch.float64)
    start = {k: v.numpy() for m in (start.g.model, start.d.model)
             for k, v in m.state_dict().items()}
    runs, final, trackers = {}, {}, {}
    for dtype in (torch.float64, torch.float32):
        fs = _port_state(nets, dtype)
        trackers[dtype] = BiasedRunningVar(fs.g.model), BiasedRunningVar(fs.d.model)
        step = make_be_font_train_step(fs.g.model, fs.d.model)
        runs[dtype] = [{k: float(v) for k, v in step(fs, *_torch_batch(b, dtype))[1].items()}
                       for b in batches]
        final[dtype] = {k: v.double().numpy() for m in (fs.g.model, fs.d.model)
                        for k, v in m.state_dict().items()}
        if dtype == torch.float64:
            f64_models = fs.g.model, fs.d.model
    assert fs.g.step == fs.style.step == fs.d.step == 3
    jfs, jstep = create_font_state(g, d, gv, dv, LR), jax_step(g, d, LR)
    for i, b in enumerate(batches):
        jfs, jm = jstep(jfs, *map(jnp.asarray, b))
        got, f64 = runs[torch.float32][i], runs[torch.float64][i]
        assert list(got) == list(METRIC_KEYS)
        for k in METRIC_KEYS:
            want = float(jm[k])
            if i == 0 and k != "loss_embed":
                np.testing.assert_allclose(got[k], want, rtol=F32_TOL, err_msg=f"step {i} {k}")
            else:
                assert abs(got[k] - f64[k]) <= 2 * abs(want - f64[k]) + F32_TOL * abs(f64[k]), (
                    i, k, got[k], want, f64[k])
    jfs = jax.device_get(jfs)
    want = {**be_font_state_dict_from_jax(jfs.g.params, jfs.g.batch_stats),
            **be_font_disc_state_dict_from_jax(jfs.d.params, jfs.d.batch_stats)}
    got = {**trackers[torch.float32][0].state_dict(fs.g.model),
           **trackers[torch.float32][1].state_dict(fs.d.model)}
    f64_bn = {**trackers[torch.float64][0].state_dict(f64_models[0]),
              **trackers[torch.float64][1].state_dict(f64_models[1])}
    params = {n for m in (fs.g.model, fs.d.model) for n, _ in m.named_parameters()}
    for k, w in want.items():
        w, v = w.numpy(), got[k]
        if k in params:
            # Adam's first three steps move a weight at most 1.003 lr each
            # (Cauchy-Schwarz on the bias-corrected moments), either way
            flips = 2 * 1.01 * LR * len(batches)
            assert np.abs(v - final[torch.float64][k]).max() <= flips, k
            assert np.abs(v - w).max() <= flips, k
            if _zero_exact(k):
                assert np.array_equal(v, start[k]) and np.array_equal(w, start[k]), k
        elif k.endswith(("running_mean", "running_var")):
            ref = f64_bn[k]
            norm = np.linalg.norm
            assert norm(v - ref) <= 2 * norm(w - ref) + 1e-3 * norm(ref), k


def test_each_phase_leaves_the_rest_alone(nets):
    """The D phase moves only D; the G phase leaves D's weights and D's
    .grad as the D phase left them, and the style encoder (no gradient)
    unchanged; the S phase moves only the style encoder."""
    fs = _port_state(nets, torch.float32)
    step = make_be_font_train_step(fs.g.model, fs.d.model)
    batch = _torch_batch(_batch(6, np.float32), torch.float32)
    snap = lambda m: {k: p.detach().clone() for k, p in m.named_parameters()}
    g0 = snap(fs.g.model)
    fs, _ = step.d_phase(fs, *batch)
    assert all(torch.equal(p, g0[k]) for k, p in fs.g.model.named_parameters())
    d1 = snap(fs.d.model)
    d_grads = {k: p.grad.clone() for k, p in fs.d.model.named_parameters()}
    fs, _ = step.g_phase(fs, *batch)
    for k, p in fs.d.model.named_parameters():
        assert p.requires_grad and torch.equal(p, d1[k]) and torch.equal(p.grad, d_grads[k]), k
    g2 = snap(fs.g.model)
    for k, p in fs.g.model.named_parameters():
        moved = not torch.equal(p, g0[k])
        assert moved is not (k.startswith("style_encoder.") or _zero_exact(k)), k
    fs, _ = step.s_phase(fs, *batch)
    for k, p in fs.g.model.named_parameters():
        assert torch.equal(p, g2[k]) is not k.startswith("style_encoder."), k


def test_bf16_step_keeps_f32_state(nets):
    """Under bf16 autocast (D's sigmoid and every loss in f32) the nine
    metrics are finite and within BF16_BUDGET of the f32 step's; parameters,
    gradients, Adam's moments and BatchNorm buffers stay f32."""
    batch = _torch_batch(_batch(7, np.float32), torch.float32)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        fs = _port_state(nets, torch.float32)
        fs, m = make_be_font_train_step(fs.g.model, fs.d.model, dtype)(fs, *batch)
        out[dtype] = {k: float(v) for k, v in m.items()}
    for k in METRIC_KEYS:
        f32, bf16 = out[torch.float32][k], out[torch.bfloat16][k]
        assert np.isfinite(bf16) and abs(bf16 - f32) < BF16_BUDGET[k] * abs(f32), (k, f32, bf16)
    assert out[torch.float32] != out[torch.bfloat16]
    for state in (fs.g, fs.style, fs.d):
        for name, t in state.model.state_dict().items():
            assert t.dtype in (torch.float32, torch.int64), name
        for s in state.optimizer.state.values():
            assert s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32


def test_font_state_round_trip_and_resume(nets, tmp_path):
    """A FontState saved after a step (keys g, style, d) restores whole into
    a fresh one, and the next step equals a run that never stopped."""
    batches = [_torch_batch(_batch(8 + i, np.float32), torch.float32) for i in range(2)]
    fs = _port_state(nets, torch.float32)
    step = make_be_font_train_step(fs.g.model, fs.d.model)
    fs, _ = step(fs, *batches[0])
    path = save_state(Checkpointer(str(tmp_path)), 0, fs)
    assert sorted(torch.load(path, weights_only=True)) == ["d", "g", "style"]
    _, straight = step(fs, *batches[1])
    resumed, tag = restore_state(str(tmp_path), _port_state(nets, torch.float32))
    assert tag == 0 and resumed.g.step == resumed.style.step == resumed.d.step == 1
    _, m = make_be_font_train_step(resumed.g.model, resumed.d.model)(resumed, *batches[1])
    assert {k: float(v) for k, v in m.items()} == {k: float(v) for k, v in straight.items()}
