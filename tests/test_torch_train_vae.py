"""The port's circle VAE-GAN training (vaeplay_torch.train.steps_vae,
GroupedTrainState, the bf16 autocast policy) against the JAX package's, on
the CPU: f64 gradients of every parameter and one f64 RMSprop step, a
4-step f32 trajectory, the on-device circle step, the remat step, and bf16
against the port's own f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from vaeplay_torch.data.circles import CircleDataset, encode_targets, render_circle_np
from vaeplay_torch.models import vae_gan as TV
from vaeplay_torch.models.convert import vaegan_state_dict_from_jax
from vaeplay_torch.train import steps_vae as TS
from vaeplay_torch.train.checkpoint import Checkpointer, restore_state, save_state
from vaeplay_torch.train.state import GroupedTrainState, torch_rmsprop
from vaeplay_torch.utils.amp import autocast, resolve_dtype
from vaeplay_tpu.models.torch_convert import vaegan_from_torch
from vaeplay_tpu.models.vae_gan import VaeGan
from vaeplay_tpu.train.state import TrainState as JaxTrainState
from vaeplay_tpu.train.state import grouped_transform
from vaeplay_tpu.train.state import torch_rmsprop as jax_rmsprop
from vaeplay_tpu.train.steps_vae import vae_gan_losses as jax_losses

IMG, Z, B, LR = 32, 32, 4, 1e-4
F64_TOL = 1e-9  # of each tensor's largest magnitude
TRAJ_KEYS = ("loss_recon", "kl", "loss_aux", "loss_discriminator")


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
    model = VaeGan(img_size=IMG, z_size=Z)
    v = jax.jit(model.init)({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                            jnp.zeros((2, IMG, IMG, 1)))
    return model, jax.device_get(v["params"]), jax.device_get(v["batch_stats"])


def _port(params, stats, dtype=torch.float32) -> TV.VaeGan:
    port = TV.VaeGan(img_size=IMG, z_size=Z)
    port.load_state_dict(vaegan_state_dict_from_jax(params, stats, IMG))
    return port.to(dtype)


def _state(port) -> GroupedTrainState:
    return GroupedTrainState.create(port, {g: torch_rmsprop(LR) for g in TS.GROUPS})


def _jax_state(model, params, stats, dtype=jnp.float32):
    cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), dtype), t)
    tx = grouped_transform({g: jax_rmsprop(LR) for g in TS.GROUPS}, params)
    return JaxTrainState.create(model.apply, cast(params), cast(stats), tx)


def _jax_step(model):
    """The JAX package's step with injected noise (as
    tests/test_parity_trajectory.py builds it): grad of the summed five
    losses, then the grouped RMSprop update."""

    def loss_fn(p, bs, imgs, targets, eps, z_p):
        outs, mut = model.apply({"params": p, "batch_stats": bs}, imgs, train=True,
                                noise=(eps, z_p), mutable=["batch_stats"])
        m = jax_losses(outs, imgs, targets)
        total = (m["loss_recon"] + m["loss_encoder"] + m["loss_decoder"]
                 + m["loss_discriminator"] + m["loss_aux"])
        return total, (m, mut["batch_stats"])

    @jax.jit
    def step(state, imgs, targets, eps, z_p):
        grads, (m, bs) = jax.grad(loss_fn, has_aux=True)(state.params, state.batch_stats,
                                                          imgs, targets, eps, z_p)
        return state.apply_gradients(grads, new_batch_stats=bs), m, grads

    return step


def _batch(seed, dtype=np.float32):
    """Uniform-noise images (no exact zeros after the zero-bias convs) and
    encoded-scale targets, NHWC for JAX."""
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(size=(B, IMG, IMG, 1)).astype(dtype)
    targets = (rng.normal(size=(B, 3)) * 0.5).astype(dtype)
    return imgs, targets


def _nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _jax_tree(port, values):
    """Per-parameter arrays named as the port's parameters -> the JAX params
    tree (flattened) through vaegan_from_torch; the buffers it also reads are
    taken from the port."""
    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    sd.update(values)
    return traverse_util.flatten_dict(vaegan_from_torch(sd, IMG)[0])


def _assert_trees_close(got, want, tol, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k], w, atol=tol * max(np.abs(w).max(), 1e-30), rtol=0,
                                   err_msg=f"{what} {k}")


def _noise(port, seed):
    """The (eps, z_p) a step draws from a generator seeded `seed`."""
    return port.draw_noise(B, torch.Generator().manual_seed(seed), torch.device("cpu"))


def test_f64_gradients_match_jax(jax_init):
    """Every parameter's gradient of the summed five losses, in f64 on both
    sides (in f32 a BN'd conv's weight gradient cancels catastrophically, so
    only f64 can hold the wiring tightly): within 1e-9 of each tensor's max."""
    model, params, stats = jax_init
    imgs, targets = _batch(7, np.float64)
    port = _port(params, stats, torch.float64).train()
    eps, z_p = _noise(port, 3)
    outs = port(_nchw(imgs), noise=(eps, z_p))
    m = TS.vae_gan_losses(outs, _nchw(imgs), torch.from_numpy(targets))
    sum(m[k] for k in TS.METRIC_KEYS[:5]).backward()
    got = _jax_tree(port, {k: p.grad.numpy() for k, p in port.named_parameters()})
    with jax.enable_x64(True):
        st = _jax_state(model, params, stats, jnp.float64)
        _, jm, grads = _jax_step(model)(st, jnp.asarray(imgs), jnp.asarray(targets),
                                        jnp.asarray(eps.numpy()), jnp.asarray(z_p.numpy()))
        want = traverse_util.flatten_dict(jax.device_get(grads))
        for k in TS.METRIC_KEYS:
            np.testing.assert_allclose(float(m[k].detach()), float(jm[k]), rtol=1e-10, err_msg=k)
    _assert_trees_close(got, want, F64_TOL, "gradient")


def test_f64_step_matches_jax(jax_init):
    """One f64 step through make_train_step (noise drawn from the step's
    generator) against the JAX step: the losses, every gradient and every
    RMSprop square average (optax's nu) within 1e-9 of each tensor's max,
    every parameter within that plus the update's slope times its
    gradients' difference."""
    model, params, stats = jax_init
    imgs, targets = _batch(8, np.float64)
    port = _port(params, stats, torch.float64).train()
    eps, z_p = _noise(port, 4)
    state, metrics = TS.make_train_step(port)(_state(port), _nchw(imgs), torch.from_numpy(targets),
                                              torch.Generator().manual_seed(4))
    assert state.step == 1 and sorted(metrics) == sorted(TS.METRIC_KEYS)
    with jax.enable_x64(True):
        st, jm, grads = _jax_step(model)(_jax_state(model, params, stats, jnp.float64),
                                         jnp.asarray(imgs), jnp.asarray(targets),
                                         jnp.asarray(eps.numpy()), jnp.asarray(z_p.numpy()))
        st, grads = jax.device_get((st, grads))
    for k in TS.METRIC_KEYS:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), rtol=1e-10, err_msg=k)
    got_g = _jax_tree(port, {k: p.grad.numpy() for k, p in port.named_parameters()})
    want_g = traverse_util.flatten_dict(grads)
    _assert_trees_close(got_g, want_g, F64_TOL, "gradient")
    # the first update lr * g / (0.1 |g| + 1e-8) has slope up to lr / 1e-8 = 1e4
    # at g = 0: a gradient's f64 rounding there moves the weight 1e4 times as
    # far, so each weight may also differ by 1e4 x its gradients' difference
    got, want = _jax_tree(port, {}), traverse_util.flatten_dict(st.params)
    assert sorted(got) == sorted(want)
    for k in want:
        bound = (F64_TOL * np.abs(want[k]).max()
                 + 1.001 * LR / 1e-8 * np.abs(got_g[k] - want_g[k]))
        assert (np.abs(got[k] - want[k]) <= bound).all(), ("parameter", k)
    for group, opt in state.optimizers.items():
        names = {id(p): n for n, p in port.named_parameters()}
        sq = {f"{group}.{names[id(p)][len(group) + 1:]}": opt.state[p]["square_avg"].numpy()
              for p in opt.state}
        assert len(sq) == len(list(getattr(port, group).parameters()))
        got_sq = {k: v for k, v in _jax_tree(port, sq).items() if k[0] == group}
        nu = st.opt_state.inner_states[group].inner_state[0].nu[group]
        want_sq = {(group,) + k: v for k, v in traverse_util.flatten_dict(nu).items()}
        _assert_trees_close(got_sq, want_sq, F64_TOL, f"{group} square_avg")
    assert int(st.step) == 1


def _f32_run(jax_init, steps, dtype=torch.float32, seed0=20):
    """`steps` port steps from the JAX init on noise-image batches; returns
    the metrics per step as floats and the final state."""
    _, params, stats = jax_init
    port = _port(params, stats).train()
    state, step = _state(port), TS.make_train_step(port, dtype)
    out = []
    for i in range(steps):
        imgs, targets = _batch(seed0 + i)
        state, m = step(state, _nchw(imgs), torch.from_numpy(targets),
                        torch.Generator().manual_seed(seed0 + i))
        out.append({k: float(v) for k, v in m.items()})
    return out, state


def test_f32_trajectory_tracks_jax(jax_init):
    """4 f32 steps on the same batches and noise. RMSprop's first steps move
    every weight by about 10 x lr x sign(g), so rounding-sized gradients flip
    signs between frameworks and the runs part slowly: the envelope of
    tests/test_parity_trajectory.py:242-253 (first 3 steps within 3e-2, mean
    relative gap under 0.12 and mean shift under 0.06)."""
    model, params, stats = jax_init
    port_curve, _ = _f32_run(jax_init, 4)
    jstate, jstep = _jax_state(model, params, stats), _jax_step(model)
    jax_curve = []
    noise_port = TV.VaeGan(img_size=IMG, z_size=Z)
    for i in range(4):
        imgs, targets = _batch(20 + i)
        eps, z_p = _noise(noise_port, 20 + i)
        jstate, jm, _ = jstep(jstate, jnp.asarray(imgs), jnp.asarray(targets),
                              jnp.asarray(eps.numpy()), jnp.asarray(z_p.numpy()))
        jax_curve.append({k: float(v) for k, v in jm.items()})
    for k in TRAJ_KEYS:
        t = np.asarray([r[k] for r in jax_curve])
        j = np.asarray([r[k] for r in port_curve])
        np.testing.assert_allclose(j[:3], t[:3], rtol=3e-2, atol=3e-2, err_msg=k)
        rel = np.abs(j - t) / np.maximum(np.abs(t), 1e-3)
        shift = abs(j.mean() - t.mean()) / max(abs(t.mean()), 1e-3)
        assert rel.mean() < 0.12 and shift < 0.06, (k, t, j)
    np.testing.assert_allclose(port_curve[0]["loss_recon"], jax_curve[0]["loss_recon"], rtol=1e-4)


def test_every_parameter_gets_a_gradient(jax_init):
    """After a step every parameter tensor holds a nonzero gradient (the
    step's zero_grad sets them to None first), so each of the four groups
    gets one, and every optimizer stepped every tensor of its group."""
    _, state = _f32_run(jax_init, 1)
    for name, p in state.model.named_parameters():
        assert p.grad is not None and bool(p.grad.abs().sum() > 0), name
    for group, opt in state.optimizers.items():
        assert len(opt.state) == len(list(getattr(state.model, group).parameters())), group


def test_circle_step_equals_step_on_host_rendered_images(jax_init):
    """make_circle_train_step renders and encodes on the device from the
    (B, 3) params; the same step on images rendered on the host
    (render_circle_np, laid out as the device render is) and encode_targets
    gives the same losses, gradients and weights, bit for bit."""
    _, params, stats = jax_init
    raw = next(CircleDataset(n=IMG, min_radius=4, data_size=8, seed=1).epoch_batches(B))
    a, b = _port(params, stats).train(), _port(params, stats).train()
    _, ma = TS.make_circle_train_step(a, IMG)(_state(a), torch.from_numpy(raw),
                                              torch.Generator().manual_seed(5))
    host = torch.from_numpy(np.stack([render_circle_np(IMG, x, y, r)[..., 0] for r, x, y in raw]))
    _, mb = TS.make_train_step(b)(_state(b), host[:, None],
                                  torch.from_numpy(encode_targets(IMG, raw)),
                                  torch.Generator().manual_seed(5))
    imgs, targets = TS.circle_batch(IMG, torch.from_numpy(raw))
    assert torch.equal(imgs, host[:, None]) and imgs.stride() == host[:, None].stride()
    assert torch.equal(targets, torch.from_numpy(encode_targets(IMG, raw)))
    for k in TS.METRIC_KEYS:
        assert torch.equal(ma[k], mb[k]), k
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa.grad, pb.grad) and torch.equal(pa, pb), name
    for (name, ba), bb in zip(a.named_buffers(), b.buffers()):
        assert torch.equal(ba, bb), name


def test_remat_step_equals_plain_step(jax_init):
    """Checkpointing the forward recomputes it in the backward; the losses,
    the weights and the BatchNorm running buffers (updated once, not again
    in the recompute) after a step are the plain step's, for the f32 and the
    bf16 policy."""
    _, params, stats = jax_init
    imgs, targets = _batch(30)
    for dtype in (torch.float32, torch.bfloat16):
        runs = []
        for remat in (False, True):
            port = _port(params, stats).train()
            state, m = TS.make_train_step(port, dtype, remat)(
                _state(port), _nchw(imgs), torch.from_numpy(targets),
                torch.Generator().manual_seed(6))
            runs.append((port.state_dict(), m))
        (sd0, m0), (sd1, m1) = runs
        for k in m0:
            assert torch.equal(m0[k], m1[k]), (dtype, k)
        for k in sd0:
            torch.testing.assert_close(sd1[k], sd0[k], rtol=0, atol=1e-7, msg=f"{dtype} {k}")
            if "running" in k or "num_batches" in k:
                assert torch.equal(sd1[k], sd0[k]), (dtype, k)


def test_bf16_tracks_f32_and_keeps_f32_state(jax_init):
    """The bf16 autocast policy against the port's own f32 over 4 steps,
    within tests/test_bf16.py's budget: step 1 (identical states) every loss
    within 5% relative and recon within 0.05; every step recon within 0.1
    and finite. Parameters, RMSprop state and BN buffers stay f32."""
    f32, _ = _f32_run(jax_init, 4, seed0=40)
    bf16, state = _f32_run(jax_init, 4, torch.bfloat16, seed0=40)
    assert abs(bf16[0]["loss_recon"] - f32[0]["loss_recon"]) < 0.05
    for k in f32[0]:
        assert abs(bf16[0][k] - f32[0][k]) / (abs(f32[0][k]) + 1e-6) < 0.05, (k, bf16[0], f32[0])
    for s32, s16 in zip(f32, bf16):
        assert abs(s16["loss_recon"] - s32["loss_recon"]) < 0.1, (s16, s32)
        assert all(np.isfinite(v) for v in s16.values()), s16
    assert bf16[0]["loss_recon"] != f32[0]["loss_recon"]  # bf16 really ran
    for name, t in state.model.state_dict().items():
        if t.is_floating_point():
            assert t.dtype == torch.float32, name
    for p in state.model.parameters():
        assert p.grad.dtype == torch.float32
    for opt in state.optimizers.values():
        for s in opt.state.values():
            assert s["square_avg"].dtype == torch.float32


def test_sub_ulp_running_mean_increments_survive():
    """Under bf16 autocast a BatchNorm takes bf16 activations, returns bf16,
    and keeps its running buffers f32: EMA increments far below the bf16 ulp
    accumulate (the JAX package needs merge_batch_stats for this,
    tests/test_bf16.py::test_merge_batch_stats_preserves_sub_ulp_increments)."""
    bn = torch.nn.BatchNorm1d(1, momentum=1e-3)  # increment 1e-3 x (batch - running)
    with torch.no_grad():
        bn.running_mean.fill_(1.0)
    target = 1.0078125  # a bf16 value; its step of 7.8e-6 is far below bf16's 2^-7 at 1
    x = torch.full((8, 1), target, dtype=torch.bfloat16)
    layer = torch.nn.Linear(1, 1, bias=False)
    torch.nn.init.ones_(layer.weight)
    for _ in range(50):
        with autocast(torch.device("cpu"), torch.bfloat16):
            y = bn(layer(x.float()))
        assert y.dtype == torch.bfloat16 and bn.running_mean.dtype == torch.float32
    exact = 1.0 + (target - 1.0) * (1 - (1 - 1e-3) ** 50)
    assert abs(float(bn.running_mean[0]) - exact) < 5e-6, (float(bn.running_mean[0]), exact)
    naive = torch.tensor(1.0)
    for _ in range(50):  # the defective policy: requantize the running value each step
        naive = ((1 - 1e-3) * naive + 1e-3 * target).bfloat16().float()
    assert float(naive) == 1.0 and float(bn.running_mean[0]) > 1.0 + 3e-4


def test_resolve_dtype_and_autocast():
    assert resolve_dtype("bf16") is resolve_dtype("bfloat16") is torch.bfloat16
    assert resolve_dtype("float32") is resolve_dtype("f32") is torch.float32
    with pytest.raises(ValueError):
        resolve_dtype("float16")
    with pytest.raises(ValueError):
        autocast(torch.device("cpu"), torch.float16)
    lin = torch.nn.Linear(4, 4)
    with autocast(torch.device("cpu"), torch.float32):
        assert lin(torch.ones(1, 4)).dtype == torch.float32


def test_grouped_state_round_trip_and_groups(jax_init, tmp_path):
    """A GroupedTrainState saved after a step restores into fresh objects
    with the same weights, step and RMSprop state; the next step then
    matches a run that never stopped. create() refuses groups that do not
    cover the model."""
    _, params, stats = jax_init
    straight, _ = _f32_run(jax_init, 2, seed0=50)
    _, first = _f32_run(jax_init, 1, seed0=50)
    save_state(Checkpointer(str(tmp_path)), 0, first)
    port = _port(params, stats).train()
    resumed, tag = restore_state(str(tmp_path), _state(port))
    assert tag == 0 and resumed.step == 1
    for group, opt in first.optimizers.items():
        want, got = opt.state_dict(), resumed.optimizers[group].state_dict()
        assert want["param_groups"] == got["param_groups"]
        for i, s in want["state"].items():
            assert torch.equal(got["state"][i]["square_avg"], s["square_avg"])
    imgs, targets = _batch(51)
    _, m = TS.make_train_step(port)(resumed, _nchw(imgs), torch.from_numpy(targets),
                                    torch.Generator().manual_seed(51))
    assert {k: float(v) for k, v in m.items()} == straight[1]
    with pytest.raises(ValueError, match="do not cover"):
        GroupedTrainState.create(port, {g: torch_rmsprop(LR) for g in TS.GROUPS[:3]})
