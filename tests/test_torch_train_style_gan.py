"""The port's Style_GAN step (vaeplay_torch.train.steps_style_gan) against
the JAX package's, on the CPU at 32 px, z 32, batch 4 (sorted label-0
first, two of each): one step of the JAX recipe in f64 with recorded noise
(the seven losses, E's gradients of the E/G phase, G's of the E/G phase
plus the x_gen branch taken with the updated E, D's of the D phase), three
f32 steps against make_style_gan_train_step(recorded_noise=True) itself,
the shared x_gen branch against the literal two-pass form, what each phase
leaves alone, the bucketed step against the blended one, the host sort
against JAX's, bf16 against f32, and the StyleGanState checkpoint round
trip.

The JAX step casts outputs to f32 even under x64 (amp.to_f32), so the f64
test composes its recipe from the JAX models, losses and TrainState, the
JAX step's own body without the casts. StyleUp's transposed-conv bias
feeds a parameter-free instance norm: its true gradient is 0 and both
sides hold rounding, so it is held to the bound of its layer's weight
gradient, and under Adam it takes lr-sized steps of either sign."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_style_gan import IMG, Z, init_nets, port_nets, to_nchw
from vaeplay_torch.models import style_gan as TS
from vaeplay_torch.models.convert import (style_discriminator_state_dict_from_jax,
                                          style_encoder_state_dict_from_jax,
                                          style_generator_state_dict_from_jax)
from vaeplay_torch.ops import losses as TL
from vaeplay_torch.train.checkpoint import Checkpointer, restore_state, save_state
from vaeplay_torch.train.state import StyleGanState
from vaeplay_torch.train.steps_style_gan import (AVG_KEYS, make_style_gan_train_step,
                                                 sort_batch_by_label)
from vaeplay_tpu.ops import losses as JLoss
from vaeplay_tpu.train.state import TrainState as JaxTrainState
from vaeplay_tpu.train.state import torch_adam
from vaeplay_tpu.train.steps_style_gan import StyleGanState as JaxStyleGanState
from vaeplay_tpu.train.steps_style_gan import make_style_gan_train_step as jax_step
from vaeplay_tpu.train.steps_style_gan import sort_batch_by_label as jax_sort

B, LR, SPLIT = 4, 1e-4, (2, 2)
LABELS = np.array([0, 0, 1, 1])
F64_TOL = 1e-9  # f64 gradients: of each tensor's largest magnitude; losses relative
F32_TOL = 1e-3  # three f32 steps: each loss, relative
UPDATE_TOL = 0.10  # three f32 steps: of each tensor's f64 update norm
ZERO_GRAD = "up_convs.0.bias"  # the transposed conv before StyleUp's instance norm
# bf16 losses against f32 (tests/test_bf16_families.py:22-29 and :146-151):
# 5% + 0.05, and 10% on the KL, a sum over the batch and z
BF16_REL = {k: 0.05 for k in AVG_KEYS} | {"g_rec_kl_loss": 0.10}


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    return init_nets(seed=5)


def _batch(seed, dtype=np.float64):
    """Noise x_target and x_content (NHWC), eps and z_sample."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(B, IMG, IMG, 3)).astype(dtype),
            rng.uniform(size=(B, IMG, IMG, 3)).astype(dtype),
            rng.normal(size=(B, Z)).astype(dtype), rng.normal(size=(B, Z)).astype(dtype))


def _torch_batch(batch, dtype):
    xt, xc, eps, z = batch
    return (to_nchw(xt, dtype), to_nchw(xc, dtype), torch.from_numpy(LABELS),
            torch.from_numpy(eps).to(dtype), torch.from_numpy(z).to(dtype))


def _port_state(nets, dtype) -> StyleGanState:
    return StyleGanState.create(*port_nets(nets[1], dtype), LR)


def _jax_state(nets, dtype=jnp.float32) -> JaxStyleGanState:
    (je, jg, jd), params = nets
    c = lambda p: jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), p)
    return JaxStyleGanState(*(JaxTrainState.create(m.apply, c(p), None, torch_adam(LR))
                              for m, p in zip((je, jg, jd), params)))


def _jax_recipe(je, jg, jd):
    """The JAX step's body (steps_style_gan.py:66-135) without its f32 casts:
    (state, x_target, x_content, labels, eps, z_sample) -> (state, metrics,
    (E's E/G-phase gradients, G's summed gradients, D's gradients))."""
    E = lambda p, x: je.apply({"params": p}, x, train=True)
    G = lambda p, xc, z, y: jg.apply({"params": p}, xc, z, y, train=True)
    D = lambda p, x, xc: jd.apply({"params": p}, x, xc, train=True)

    def d_terms(valid, typ, labels, target):
        return (jnp.mean(JLoss.bce(valid, jnp.full_like(valid, target)))
                + jnp.mean(JLoss.softmax_cross_entropy(typ, labels)))

    @jax.jit
    def step(ss, x_target, x_content, labels, eps, z_sample):
        e, g, d = ss.e, ss.g, ss.d
        x_gen, g_vjp = jax.vjp(lambda gp: G(gp, x_content, z_sample, labels), g.params)

        def eg_loss(ep, gp, xg):
            mu, logvar = E(ep, x_target)
            x_rec = G(gp, x_content, eps * jnp.exp(logvar / 2.0) + mu, labels)
            m = {"g_rec_kl_loss": 0.5 * jnp.sum(jnp.exp(logvar) + mu ** 2 - logvar - 1.0),
                 "g_rec_d_loss": d_terms(*D(d.params, x_rec, x_content), labels, 1.0),
                 "g_rec_pixel_loss": jnp.mean(jnp.abs(x_rec - x_target)),
                 "g_gen_d_loss": d_terms(*D(d.params, xg, x_content), labels, 1.0)}
            return sum(m.values()), (m, x_rec)

        (ge, gg, gen_cot), (m, x_rec) = jax.grad(eg_loss, argnums=(0, 1, 2), has_aux=True)(
            e.params, g.params, x_gen)
        e = e.apply_gradients(ge)
        lat, lat_cot = jax.value_and_grad(
            lambda xg: jnp.mean(jnp.abs(E(e.params, xg)[0] - z_sample)) * 0.5)(x_gen)
        gg = jax.tree_util.tree_map(jnp.add, gg, g_vjp(gen_cot + lat_cot)[0])
        g = g.apply_gradients(gg)

        def d_loss(dp):
            real = d_terms(*D(dp, x_target, x_content), labels, 1.0)
            fake = d_terms(*D(dp, jax.lax.stop_gradient(x_rec), x_content), labels, 0.0)
            return (real + fake) * 0.5, (real, fake)

        gd, (real, fake) = jax.grad(d_loss, has_aux=True)(d.params)
        m.update(loss_latent=lat, d_real_loss=real, d_fake_loss=fake)
        return JaxStyleGanState(e, g, d.apply_gradients(gd)), m, (ge, gg, gd)

    return step


@pytest.fixture(scope="module")
def jax_f64_step(nets):
    """One f64 step of the JAX recipe from nets: (batch, metrics, the three
    gradient trees as port state_dicts)."""
    batch = _batch(6)
    with jax.enable_x64(True):
        ss = _jax_state(nets, jnp.float64)
        args = [jnp.asarray(a) for a in batch]
        _, m, (ge, gg, gd) = _jax_recipe(*nets[0])(ss, args[0], args[1], jnp.asarray(LABELS),
                                                   args[2], args[3])
        m, ge, gg, gd = jax.device_get((m, ge, gg, gd))
    return batch, m, (style_encoder_state_dict_from_jax(ge),
                      style_generator_state_dict_from_jax(gg),
                      style_discriminator_state_dict_from_jax(gd))


def _check_grads(model, want, tol=F64_TOL):
    """Each .grad within tol of the wanted gradient's largest magnitude; the
    ZERO_GRAD biases within tol of their layer's weight gradient's."""
    for name, p in model.named_parameters():
        w = want[name].numpy()
        assert p.grad is not None and p.grad.dtype == torch.float64, name
        scale = np.abs(w).max()
        if name.endswith(ZERO_GRAD):
            scale = np.abs(want[name.replace(".bias", ".weight")].numpy()).max()
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), w, atol=tol * scale, rtol=0, err_msg=name)


def test_f64_step_matches_jax(nets, jax_f64_step):
    """The seven losses within 1e-9 relative; E's, G's and D's gradients."""
    batch, jm, want = jax_f64_step
    ss = _port_state(nets, torch.float64)
    step = make_style_gan_train_step(ss.e.model, ss.g.model, ss.d.model, Z)
    ss, m = step.recorded(ss, *_torch_batch(batch, torch.float64))
    assert list(m) == list(AVG_KEYS) and ss.e.step == ss.g.step == ss.d.step == 1
    for k in AVG_KEYS:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=F64_TOL, err_msg=k)
    for model, w in zip((ss.e.model, ss.g.model, ss.d.model), want):
        assert sorted(w) == sorted(n for n, _ in model.named_parameters())
        _check_grads(model, w)


def test_f32_steps_track_jax_step(nets):
    """Three f32 steps of the port and of the JAX package's
    make_style_gan_train_step(recorded_noise=True) from the same weights on
    the same batches and noise, beside three f64 steps of the port (whose
    step equals JAX's recipe at 1e-9, above).

    Step 0's losses are within F32_TOL of JAX's. From step 1 on both
    frameworks' f32 runs leave the f64 one by more than that: Adam moves
    each weight by about lr x sign(g) whatever |g| is, so a gradient whose
    sign f32 rounding decides moves its weight by lr either way (sSE's
    one-channel biases, among others), and flax's f32 instance norm takes its
    variance as E[x^2] - E[x]^2. There each port loss is held no farther
    from the f64 run's than twice JAX's is, plus F32_TOL of it. After the
    three steps each weight tensor's update is no farther, in norm, from the
    f64 run's update than twice JAX's is, plus UPDATE_TOL of the f64
    update's norm; the ZERO_GRAD biases (gradient rounding on every side)
    are held to Adam's bound, 1.01 lr a step and element."""
    batches = [_batch(10 + i, np.float32) for i in range(3)]
    runs, updates = {}, {}
    for dtype in (torch.float64, torch.float32):
        ss = _port_state(nets, dtype)
        start = {k: v.double().clone() for k, v in _state_weights(ss).items()}
        step = make_style_gan_train_step(ss.e.model, ss.g.model, ss.d.model, Z)
        runs[dtype] = [{k: float(v) for k, v in step.recorded(ss, *_torch_batch(b, dtype))[1].items()}
                       for b in batches]
        updates[dtype] = {k: v.double() - start[k] for k, v in _state_weights(ss).items()}
    assert ss.e.step == ss.g.step == ss.d.step == 3
    jss = _jax_state(nets)
    jstep = jax_step(*nets[0], z_dim=Z, recorded_noise=True)
    for i, b in enumerate(batches):
        xt, xc, eps, z = map(jnp.asarray, b)
        jss, jm = jstep(jss, xt, xc, jnp.asarray(LABELS), eps, z)
        got, f64 = runs[torch.float32][i], runs[torch.float64][i]
        assert list(got) == list(AVG_KEYS)
        for k in AVG_KEYS:
            want = float(jm[k])
            if i == 0:
                np.testing.assert_allclose(got[k], want, rtol=F32_TOL, err_msg=f"step 0 {k}")
            else:
                assert abs(got[k] - f64[k]) <= 2 * abs(want - f64[k]) + F32_TOL * abs(f64[k]), (
                    i, k, got[k], want, f64[k])
    jss = jax.device_get(jss)
    want = {**{f"e.{k}": v for k, v in style_encoder_state_dict_from_jax(jss.e.params).items()},
            **{f"g.{k}": v for k, v in style_generator_state_dict_from_jax(jss.g.params).items()},
            **{f"d.{k}": v for k, v in
               style_discriminator_state_dict_from_jax(jss.d.params).items()}}
    start = {k: v.double() for k, v in _state_weights(_port_state(nets, torch.float32)).items()}
    assert sorted(updates[torch.float32]) == sorted(want)
    for k, w in want.items():
        du, d64, dj = updates[torch.float32][k], updates[torch.float64][k], w.double() - start[k]
        if k.endswith(ZERO_GRAD):
            assert max(float(du.abs().max()), float(dj.abs().max())) <= 3 * 1.01 * LR, k
            continue
        assert (du - d64).norm() <= 2 * (dj - d64).norm() + UPDATE_TOL * d64.norm(), k


def _state_weights(ss: StyleGanState):
    return {f"{net}.{k}": p.detach() for net in ("e", "g", "d")
            for k, p in getattr(ss, net).model.named_parameters()}


def _literal_grads(nets, batch):
    """The literal two-pass form in f64: the E/G loss with x_gen inside its
    graph, E's step, then a second G forward for the latent loss with the
    updated E, its gradient added to G's. Returns G's summed gradients."""
    ss = _port_state(nets, torch.float64)
    e, g, d = ss.e.model, ss.g.model, ss.d.model
    xt, xc, labels, eps, z = _torch_batch(batch, torch.float64)
    d.requires_grad_(False)

    def d_terms(valid, typ):
        return (TL.bce(valid, torch.ones_like(valid)).mean()
                + TL.softmax_cross_entropy(typ, labels).mean())

    mu, logvar = e(xt)
    x_rec = g(xc, eps * torch.exp(logvar / 2) + mu, labels)
    total = (0.5 * torch.sum(torch.exp(logvar) + mu ** 2 - logvar - 1) + d_terms(*d(x_rec, xc))
             + (x_rec - xt).abs().mean() + d_terms(*d(g(xc, z, labels), xc)))
    total.backward()
    ss.e.apply_gradients()
    lat = (e(g(xc, z, labels))[0] - z).abs().mean() * 0.5
    params = list(g.parameters())
    return {n: p.grad + lg for (n, p), lg in zip(g.named_parameters(),
                                                  torch.autograd.grad(lat, params))}


def test_shared_branch_equals_two_pass(nets, jax_f64_step):
    """G's gradient from the step (one x_gen forward, one backward of the
    summed cotangents) equals the literal two-pass form's, f64 within 1e-12
    of each tensor's largest."""
    batch = jax_f64_step[0]
    ss = _port_state(nets, torch.float64)
    step = make_style_gan_train_step(ss.e.model, ss.g.model, ss.d.model, Z)
    ss, _ = step.recorded(ss, *_torch_batch(batch, torch.float64))
    want = _literal_grads(nets, batch)
    _check_grads(ss.g.model, want, tol=1e-12)


def test_each_phase_leaves_the_rest_alone(nets):
    """The E/G phase moves only E, and leaves D's .grad as it was (D frozen
    meanwhile, its requires_grad restored); the latent+G phase moves only G,
    and E's .grad is the E/G phase's; the D phase moves only D."""
    ss = _port_state(nets, torch.float32)
    step = make_style_gan_train_step(ss.e.model, ss.g.model, ss.d.model, Z)
    xt, xc, labels, eps, z = _torch_batch(_batch(7, np.float32), torch.float32)
    ss, _ = step.recorded(ss, xt, xc, labels, eps, z)  # every .grad exists from here on
    snap = lambda: {k: v.clone() for k, v in _state_weights(ss).items()}
    grads = lambda net: {k: p.grad.clone() for k, p in getattr(ss, net).model.named_parameters()}

    def moved(before):
        return {k.split(".")[0] for k, v in _state_weights(ss).items()
                if not torch.equal(v, before[k])}

    w0, d_grads = snap(), grads("d")
    ss, branch, _ = step.eg_phase(ss, xt, xc, labels, eps, z)
    assert moved(w0) == {"e"}
    assert all(p.requires_grad and torch.equal(p.grad, d_grads[k])
               for k, p in ss.d.model.named_parameters())
    w1, e_grads = snap(), grads("e")
    ss, _ = step.latent_g_phase(ss, branch, z)
    assert moved(w1) == {"g"}
    assert all(torch.equal(p.grad, e_grads[k]) for k, p in ss.e.model.named_parameters())
    w2 = snap()
    ss, _ = step.d_phase(ss, xt, xc, labels, branch[2])
    assert moved(w2) == {"d"}


def test_bucketed_step_equals_blended(nets, jax_f64_step):
    """One f64 step at the (2, 2) split on the sorted batch equals the
    blended step: the losses within 1e-12 relative, every gradient within
    1e-12 of its tensor's largest."""
    batch = jax_f64_step[0]
    out = []
    for split in (None, SPLIT):
        ss = _port_state(nets, torch.float64)
        step = make_style_gan_train_step(ss.e.model, ss.g.model, ss.d.model, Z)
        ss, m = step.recorded(ss, *_torch_batch(batch, torch.float64), split)
        out.append((m, ss))
    (m0, ss0), (m1, ss1) = out
    for k in AVG_KEYS:
        np.testing.assert_allclose(float(m1[k]), float(m0[k]), rtol=1e-12, err_msg=k)
    for net in ("e", "g", "d"):
        want = {k: p.grad for k, p in getattr(ss0, net).model.named_parameters()}
        _check_grads(getattr(ss1, net).model, want, tol=1e-12)


@pytest.mark.parametrize("pad", [1, 2, 8])
def test_sort_batch_by_label_matches_jax(pad):
    """The same permutation, labels and bucket as JAX's for every count of
    label-0 rows in a batch of 8 and for a shuffled batch."""
    arr = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    cases = [np.repeat([1, 0], [8 - k0, k0]) for k0 in range(9)]
    cases.append(np.array([1, 0, 1, 0, 0, 1, 1, 1]))
    for labels in cases:
        (a,), lab, split = sort_batch_by_label(labels, arr, pad=pad)
        (ja,), jlab, jsplit = jax_sort(labels, arr, pad=pad)
        assert np.array_equal(a, ja) and np.array_equal(lab, jlab) and split == jsplit
        k0 = int((labels == 0).sum())
        assert split[0] >= k0 and split[1] >= 8 - k0 and max(split) <= 8


def test_bf16_step_keeps_f32_state(nets):
    """Under bf16 autocast the seven losses are finite and within the JAX
    package's bf16 budget of the f32 step's (5% + 0.05, the KL sum 10% +
    0.05), blended and split; parameters, gradients and Adam's moments stay
    f32."""
    batch = _torch_batch(_batch(8, np.float32), torch.float32)
    for split in (None, SPLIT):
        out = {}
        for dtype in (torch.float32, torch.bfloat16):
            ss = _port_state(nets, torch.float32)
            step = make_style_gan_train_step(ss.e.model, ss.g.model, ss.d.model, Z, dtype)
            ss, m = step.recorded(ss, *batch, split)
            out[dtype] = {k: float(v) for k, v in m.items()}
        for k in AVG_KEYS:
            f32, bf16 = out[torch.float32][k], out[torch.bfloat16][k]
            assert np.isfinite(bf16) and abs(bf16 - f32) <= BF16_REL[k] * abs(f32) + 0.05, (
                split, k, f32, bf16)
        assert out[torch.float32] != out[torch.bfloat16]
        for state in (ss.e, ss.g, ss.d):
            for name, p in state.model.named_parameters():
                assert p.dtype == p.grad.dtype == torch.float32, name
            for s in state.optimizer.state.values():
                assert s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32


def test_drawn_noise_is_seeded(nets):
    """The default form draws eps and z_sample from the step's generator:
    two runs from one seed agree, and equal the recorded form fed the same
    draws."""
    batch = _torch_batch(_batch(9, np.float32), torch.float32)[:3]
    runs = []
    for _ in range(2):
        ss = _port_state(nets, torch.float32)
        step = make_style_gan_train_step(ss.e.model, ss.g.model, ss.d.model, Z,
                                         generator=torch.Generator().manual_seed(3))
        runs.append({k: float(v) for k, v in step(ss, *batch)[1].items()})
    gen = torch.Generator().manual_seed(3)
    eps, z = torch.randn((B, Z), generator=gen), torch.randn((B, Z), generator=gen)
    ss = _port_state(nets, torch.float32)
    step = make_style_gan_train_step(ss.e.model, ss.g.model, ss.d.model, Z)
    recorded = {k: float(v) for k, v in step.recorded(ss, *batch, eps, z)[1].items()}
    assert runs[0] == runs[1] == recorded


def test_style_gan_state_round_trip_and_resume(nets, tmp_path):
    """A StyleGanState saved after a step (keys e, g, d) restores whole and
    strictly into a fresh one, and the next step equals a run that never
    stopped; a state of other widths is refused."""
    batches = [_torch_batch(_batch(20 + i, np.float32), torch.float32) for i in range(2)]
    ss = _port_state(nets, torch.float32)
    step = make_style_gan_train_step(ss.e.model, ss.g.model, ss.d.model, Z)
    ss, _ = step.recorded(ss, *batches[0])
    path = save_state(Checkpointer(str(tmp_path)), 0, ss)
    assert sorted(torch.load(path, weights_only=True)) == ["d", "e", "g"]
    _, straight = step.recorded(ss, *batches[1])
    resumed, tag = restore_state(str(tmp_path), _port_state(nets, torch.float32))
    assert tag == 0 and resumed.e.step == resumed.g.step == resumed.d.step == 1
    step = make_style_gan_train_step(resumed.e.model, resumed.g.model, resumed.d.model, Z)
    _, m = step.recorded(resumed, *batches[1])
    assert {k: float(v) for k, v in m.items()} == {k: float(v) for k, v in straight.items()}
    other = StyleGanState.create(TS.StyleEncoder(Z, IMG, max_channels=64), TS.Generator(IMG, Z),
                                 TS.Discriminator(IMG), LR)
    with pytest.raises(RuntimeError, match="size mismatch"):
        restore_state(str(tmp_path), other)
