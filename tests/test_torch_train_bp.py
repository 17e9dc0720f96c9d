"""The port's BP training (vaeplay_torch.train) against the JAX package's, on
the CPU at f32: the gradients of both passes of the two-pass step, a
3-iteration loss trajectory through Adam, the learning-rate schedule, and
checkpoint save, restore and resume; and in bf16, an iteration against the
port's f32 one and the JAX package's bf16 step."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from test_torch_bp import SMALL, _nonzero_gammas
from vaeplay_torch.data.bp_data import SyntheticEmitDataset
from vaeplay_torch.models import bp as torch_bp
from vaeplay_torch.models.convert import bp_state_dict_from_jax
from vaeplay_torch.train import steps_bp as torch_steps
from vaeplay_torch.train.checkpoint import Checkpointer, restore_state, save_state
from vaeplay_torch.train.state import TrainState, step_lr_every_two_epochs
from vaeplay_tpu.models.bp import ComposeNet
from vaeplay_tpu.models.torch_convert import bp_from_torch
from vaeplay_tpu.ops import losses as JL
from vaeplay_tpu.train.state import TrainState as JaxTrainState
from vaeplay_tpu.train.state import torch_adam
from vaeplay_tpu.train.steps_bp import _pt_loss, make_bp_train_step

IMG, B, LR = 64, 2, 1e-3
GRAD_TOL = 1e-4  # of each tensor's largest |gradient|, plus 1e-4 relative
# bf16 losses against f32 and against the JAX package's bf16 step: its
# budget (tests/test_bf16_families.py:22-29), 5% + 0.05
BF16_REL, BF16_ABS = 0.05, 0.05


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """The suite runs in several worker processes at once, and torch's
    default of one thread per core in each of them slows these CPU training
    steps ten times over; two threads a process."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_pair():
    """The JAX ComposeNet at 64 px with SMALL emit channels and nonzero
    gammas; port models are built from its params by `_port`."""
    model = ComposeNet(image_size=IMG, emit_channels=SMALL)
    variables = jax.jit(model.init)({"params": jax.random.PRNGKey(0)},
                                    jnp.zeros((1, IMG, IMG, 3)))
    return model, _nonzero_gammas(jax.device_get(variables["params"]),
                                  np.random.default_rng(4))


def _port(params) -> torch_bp.ComposeNet:
    port = torch_bp.ComposeNet(image_size=IMG, emit_channels=SMALL)
    port.load_state_dict(bp_state_dict_from_jax(params))
    return port


def _batch(seed):
    """Synthetic targets with uniform random images. The synthetic images are
    black around the bubble, and with the zero initial biases a black patch
    gives a pre-activation of exactly 0, where leaky ReLU's gradient differs
    between the frameworks: torch (the reference, and the port) takes the
    negative slope, JAX's leaky_relu takes 1."""
    _, p1, p2 = SyntheticEmitDataset(img_size=IMG).sample_batch(B, batch_seed=seed)
    imgs = np.random.default_rng(seed).uniform(size=(B, IMG, IMG, 3)).astype(np.float32)
    return imgs, p1, p2


def _jax_phase_loss(model, phase):
    def loss(params, imgs, p1, p2):
        if phase == 1:
            preds = model.apply({"params": params}, imgs, train=True)
            el = JL.ellipse_param_loss(preds["ellipse_params"], p1)
            pt = _pt_loss(preds, p2)
            return el["loss_cx"] + el["loss_cy"] + el["loss_rest"] + pt["trig_loss"] + pt["param_loss"]
        p1s = p1.at[:, :4].set(p1[:, :4] * 10.0)
        pt = _pt_loss(model.apply({"params": params}, imgs, p1s, train=True,
                                  method=model.emit_line_only), p2)
        return pt["trig_loss"] + pt["param_loss"]
    return jax.jit(jax.value_and_grad(loss))


def _port_phase_loss(port, phase, imgs, p1, p2):
    if phase == 1:
        return torch_steps.loss_phase1(port, imgs, p1, p2)[0]
    p1s = torch.cat([p1[:, :4] * 10.0, p1[:, 4:]], dim=1)
    return torch_steps.loss_phase2(port, imgs, p1s, p2)[0]


@pytest.mark.parametrize("phase", [1, 2])
def test_phase_gradients_match_jax(jax_pair, phase):
    """Every parameter's gradient of one pass, the port's mapped onto the
    JAX tree through torch_convert.bp_from_torch (the two share the
    reference's state_dict keys). Pass 2 reaches only the emit-line nets."""
    model, params = jax_pair
    imgs, p1, p2 = _batch(seed=phase)
    ref_loss, ref = _jax_phase_loss(model, phase)(params, *map(jnp.asarray, (imgs, p1, p2)))
    port = _port(params)
    if phase == 1:  # round(step) of the predicted ellipse must not sit at x.5
        with torch.no_grad():
            step = port(torch.from_numpy(imgs))["ellipse_params"][:, 4].numpy()
        assert np.abs(step % 1.0 - 0.5).min() > 1e-3
    loss = _port_phase_loss(port, phase, *map(torch.from_numpy, (imgs, p1, p2)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    got = traverse_util.flatten_dict(bp_from_torch(  # pass 2 leaves stage 1's .grad None
        {k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
         for k, p in port.named_parameters()}))
    ref = traverse_util.flatten_dict(jax.device_get(ref))
    assert sorted(got) == sorted(ref)
    for key in ref:
        r = np.asarray(ref[key])
        np.testing.assert_allclose(got[key], r, atol=GRAD_TOL * np.abs(r).max(),
                                   rtol=GRAD_TOL, err_msg=str(key))
        if phase == 2 and key[0] in ("encoder", "ellipse_predictor"):
            assert not got[key].any(), key


def test_three_iteration_trajectory_matches_jax(jax_pair):
    """Three two-pass iterations from the same weights on the same batches:
    the seven losses against make_bp_train_step with torch_adam (optax's adam
    at torch's defaults). The first within 1e-4; after that the Adam updates,
    about lr * sign(g) at first, carry the gradients' rounding into the
    weights, hence 1e-3."""
    model, params = jax_pair
    jstate = JaxTrainState.create(model.apply, jax.tree_util.tree_map(jnp.asarray, params),
                                  None, torch_adam(LR))
    jstep = make_bp_train_step(model)
    port = _port(params)
    state = TrainState.create(port, LR)
    step = torch_steps.make_bp_train_step(port)
    for it in range(3):
        imgs, p1, p2 = _batch(seed=10 + it)
        jstate, ref = jstep(jstate, *map(jnp.asarray, (imgs, p1, p2)))
        state, got = step(state, *map(torch.from_numpy, (imgs, p1, p2)))
        assert sorted(got) == sorted(ref) == sorted(torch_steps.METRIC_KEYS)
        tol = 1e-4 if it == 0 else 1e-3
        for k in ref:
            assert got[k].dim() == 0 and not got[k].requires_grad
            np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=tol, atol=tol,
                                       err_msg=f"iteration {it}: {k}")
    assert state.step == int(jstate.step) == 6


def test_bf16_iteration_within_the_jax_budget(jax_pair):
    """One two-pass iteration under bf16 autocast from the same weights and
    batch as an f32 one and as the JAX package's bf16 step
    (make_bp_train_step(compute_dtype=bfloat16)): the seven losses finite
    and within 5% + 0.05 of both; the weights and Adam's moments stay f32."""
    model, params = jax_pair
    batch = _batch(seed=40)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        port = _port(params)
        state, m = torch_steps.make_bp_train_step(port, dtype)(
            TrainState.create(port, LR), *map(torch.from_numpy, batch))
        out[dtype] = {k: float(v) for k, v in m.items()}
    jstate = JaxTrainState.create(model.apply, jax.tree_util.tree_map(jnp.asarray, params),
                                  None, torch_adam(LR))
    _, jm = make_bp_train_step(model, compute_dtype=jnp.bfloat16)(
        jstate, *map(jnp.asarray, batch))
    assert out[torch.float32] != out[torch.bfloat16]
    for k in torch_steps.METRIC_KEYS:
        got = out[torch.bfloat16][k]
        assert np.isfinite(got), k
        for want in (out[torch.float32][k], float(jm[k])):
            assert abs(got - want) <= BF16_REL * abs(want) + BF16_ABS, (k, got, want)
    for name, p in state.model.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
    for s in state.optimizer.state.values():
        assert s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32


def test_lr_schedule_matches_the_jax_cli():
    """StepLR(2, 0.1) per epoch over two optimizer steps per iteration: at 3
    iterations an epoch is 6 steps and the rate drops after 12 and 24. Adam
    driven by the LambdaLR gives the same parameters, step by step, as optax's
    adam driven by the JAX CLI's schedule (vaeplay_tpu/cli/train_bp.py:66-72)."""
    factor = step_lr_every_two_epochs(iterations=3)
    assert [factor(s) for s in (0, 11, 12, 23, 24)] == [1.0, 1.0, 0.1, 0.1, 0.1 ** 2]

    def jax_schedule(step):
        return 0.01 * (0.1 ** ((step // 6) // 2))

    w = torch.nn.Linear(1, 1, bias=False)
    torch.nn.init.constant_(w.weight, 1.0)
    state = TrainState.create(w, 0.01, factor)
    tx = optax.adam(jax_schedule)
    jw = jnp.ones((1, 1))
    opt_state = tx.init(jw)
    grads = np.cos(np.arange(26, dtype=np.float32)) + 1.5
    for s, g in enumerate(grads):
        assert state.optimizer.param_groups[0]["lr"] == pytest.approx(float(jax_schedule(s)))
        w.weight.grad = torch.full((1, 1), float(g))
        state.apply_gradients()
        updates, opt_state = tx.update(jnp.full((1, 1), g), opt_state, jw)
        jw = optax.apply_updates(jw, updates)
        # optax takes Adam's bias corrections in f32 (1 - 0.999 is off by
        # 1.3e-5 relative), torch in f64: 2e-5
        np.testing.assert_allclose(w.weight.detach().numpy(), np.asarray(jw), rtol=2e-5,
                                   err_msg=f"step {s}")
    assert state.step == 26


def _trained_state(params, steps, seed0=20):
    port = _port(params)
    state = TrainState.create(port, LR, step_lr_every_two_epochs(iterations=1))
    step = torch_steps.make_bp_train_step(port)
    for i in range(steps):
        state, _ = step(state, *map(torch.from_numpy, _batch(seed0 + i)))
    return state, step


def test_checkpoint_round_trip(jax_pair, tmp_path):
    _, params = jax_pair
    state, _ = _trained_state(params, steps=1)
    ckpt = Checkpointer(str(tmp_path / "run"))
    path = save_state(ckpt, 0, state)
    assert path.endswith("0.ckpt") and ckpt.tags() == [0] and ckpt.latest() == 0
    fresh = TrainState.create(_port(params), LR, step_lr_every_two_epochs(iterations=1))
    restored, tag = restore_state(str(tmp_path / "run"), fresh)
    assert tag == 0 and restored.step == state.step == 2
    assert restored.scheduler.last_epoch == 2
    for k, v in state.model.state_dict().items():
        assert torch.equal(restored.model.state_dict()[k], v), k
    want, got = state.optimizer.state_dict(), restored.optimizer.state_dict()
    assert want["param_groups"] == got["param_groups"]
    for i, s in want["state"].items():
        for name, t in s.items():
            assert torch.equal(got["state"][i][name], t), (i, name)


def test_resumed_run_continues_exactly(jax_pair, tmp_path):
    """Two iterations straight, against one iteration, a checkpoint, a
    restore into fresh objects and the second iteration: the same losses and
    weights, bit for bit."""
    _, params = jax_pair
    straight, _ = _trained_state(params, steps=2)
    first, _ = _trained_state(params, steps=1)
    save_state(Checkpointer(str(tmp_path)), 0, first)
    resumed, _ = restore_state(str(tmp_path),
                               TrainState.create(_port(params), LR,
                                                 step_lr_every_two_epochs(iterations=1)))
    step = torch_steps.make_bp_train_step(resumed.model)
    resumed, _ = step(resumed, *map(torch.from_numpy, _batch(21)))
    assert resumed.step == straight.step == 4
    assert resumed.optimizer.param_groups[0]["lr"] == straight.optimizer.param_groups[0]["lr"]
    for k, v in straight.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k


def test_restore_refuses_another_layout(jax_pair, tmp_path):
    _, params = jax_pair
    state, _ = _trained_state(params, steps=0)
    ckpt = Checkpointer(str(tmp_path))
    save_state(ckpt, 0, state)
    other = torch_bp.ComposeNet(image_size=IMG, emit_channels=SMALL[:-1] + ((32, 1),))
    with pytest.raises(RuntimeError, match="size mismatch"):
        restore_state(str(tmp_path), TrainState.create(other, LR))
    ckpt.save(1, {"model": state.model.state_dict(), "step": 0})
    with pytest.raises(ValueError, match="not the state's"):
        restore_state(str(tmp_path), state)
    with pytest.raises(FileNotFoundError):
        restore_state(str(tmp_path / "empty"), state)
