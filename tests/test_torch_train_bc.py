"""The port's BC training (vaeplay_torch.train.steps_bc, frozen_backbone_adam
with the epoch StepLR, bf16 autocast and bf16 refine layers) against the
JAX package's, on the CPU at a small size (the (1, 1, 1, 1) x 16 backbone,
64 px, batch 2, 16 contour points): a 3-step f32 trajectory against
make_bc_train_step with injected contours, the bf16 compute step and the
bf16 refine layers against the JAX package's, the schedule against the JAX
CLI's, a traced step, and the checkpoint round trip."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_bc import IMG, MP, SLIM, WIDTH, _contours, nchw, port_model, randomize
from vaeplay_torch.data.bc_data import SyntheticBCDataset
from vaeplay_torch.models import bc as TB
from vaeplay_torch.train import steps_bc as TS
from vaeplay_torch.train.checkpoint import Checkpointer, restore_state, save_state
from vaeplay_torch.train.state import TrainState, frozen_backbone_adam, step_lr_by_epoch
from vaeplay_tpu.models import bc as JB
from vaeplay_tpu.train.state import TrainState as JaxTrainState
from vaeplay_tpu.train.state import frozen_backbone_adam as jax_frozen_backbone_adam
from vaeplay_tpu.train.steps_bc import make_bc_train_step as jax_train_step

B, LR = 2, 1e-4
# f32 trajectory: each step's losses within 2e-5 relative of JAX's (Adam's
# first steps move each weight by about lr x sign(g); a rounding-sized
# gradient of the other sign moves it by up to 2 lr, far below this bound)
TRAJ_RTOL = 2e-5
# bf16 against the JAX package's bf16 step, same weights and batch: the first
# step's losses within 2% relative, every step within 5% (tests/test_bf16.py's
# budget for the JAX package's own bf16 against f32)
BF16_FIRST, BF16_ANY = 0.02, 0.05


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_init():
    """The slim JAX ComposeNet's init, randomized (test_torch_bc.randomize:
    drawn norms, biases and FrozenBatchNorm constants, nonzero gammas)."""
    model = JB.ComposeNet(max_points=MP, backbone_layers=SLIM, backbone_width=WIDTH)
    v = jax.device_get(jax.jit(lambda x: model.init({"params": jax.random.PRNGKey(2)}, x,
                                                     contours=_contours(0)))(
        jnp.zeros((1, IMG, IMG, 3))))
    return (model, *randomize(v, seed=1))


def batch(seed):
    """Noise images, synthetic bubble masks with their traced targets, and
    injected contours: (NHWC numpy dict, contours)."""
    b = SyntheticBCDataset(img_size=IMG, max_points=MP, data_size=B).sample_batch(B, seed)
    b["imgs"] = np.random.default_rng(seed).uniform(size=(B, IMG, IMG, 3)).astype(np.float32)
    return b, _contours(seed, B)


def port_args(b, contours):
    t = torch.from_numpy
    return ((nchw(b["imgs"]), nchw(b["bimgs"]), nchw(b["eimgs"]),
             *(t(b[k]) for k in TS.TARGET_KEYS[2:])), (t(contours[0]), t(contours[1])))


def jax_args(b, contours):
    return (jnp.asarray(b["imgs"]), *map(jnp.asarray, contours),
            *(jnp.asarray(b[k]) for k in TS.TARGET_KEYS))


def _fc_bf16(params):
    p = jax.tree_util.tree_map(lambda a: a, params)
    for name in ("fc0", "fc1"):
        p["refine_net"][name] = {k: jnp.asarray(a, jnp.bfloat16)
                                 for k, a in p["refine_net"][name].items()}
    return p


def port_run(jax_init, steps, compute=torch.float32, fc=torch.float32, seed0=10):
    _, params, stats, consts = jax_init
    port = port_model(_fc_bf16(params) if fc == torch.bfloat16 else params, stats, consts,
                      fc_dtype=fc).train()
    state, step = frozen_backbone_adam(port, LR), TS.make_bc_train_step(port, compute)
    out = []
    for i in range(steps):
        tensors, contours = port_args(*batch(seed0 + i))
        state, m = step(state, *tensors, contours=contours)
        out.append({k: float(v) for k, v in m.items()})
    return out, state


def jax_run(jax_init, steps, compute=None, fc="float32", seed0=10):
    model, params, stats, consts = jax_init
    if fc == "bfloat16":
        model = JB.ComposeNet(max_points=MP, backbone_layers=SLIM, backbone_width=WIDTH,
                              refine_fc_dtype=fc)
        params = _fc_bf16(params)
    state = JaxTrainState.create(model.apply, params, stats, jax_frozen_backbone_adam(LR),
                                 constants=consts)
    step = jax_train_step(model, max_points=MP, external_contours=True, compute_dtype=compute)
    out = []
    for i in range(steps):
        state, m = step(state, *jax_args(*batch(seed0 + i)))
        out.append({k: float(v) for k, v in m.items()})
    return out, state


def test_f32_trajectory_tracks_jax(jax_init):
    """3 f32 steps on the same batches and injected contours as the JAX
    package's make_bc_train_step with frozen_backbone_adam: each step's
    three losses within TRAJ_RTOL; the frozen stem stays as it was."""
    port_curve, state = port_run(jax_init, 3)
    jax_curve, _ = jax_run(jax_init, 3)
    for p, j in zip(port_curve, jax_curve):
        for k in TS.METRIC_KEYS:
            np.testing.assert_allclose(p[k], j[k], rtol=TRAJ_RTOL,
                                       err_msg=f"{k}: {port_curve} vs {jax_curve}")
    assert port_curve[0] != port_curve[2]
    stem = state.model.feature_net.feature.body.conv1.weight.detach().numpy()
    np.testing.assert_array_equal(np.transpose(stem, (2, 3, 1, 0)),
                                  jax_init[1]["feature_net"]["feature"]["body"]["conv1"]["kernel"])


def test_bf16_compute_tracks_jax_bf16(jax_init):
    """--dtype bfloat16: the port's autocast step against the JAX package's
    bf16 step (every parameter cast to bf16 there, the resampled features
    and the attention f32 on both sides) over 2 steps within the bf16
    budget; the port's parameters, gradients, Adam moments and buffers stay
    f32."""
    port_curve, state = port_run(jax_init, 2, compute=torch.bfloat16, seed0=20)
    jax_curve, _ = jax_run(jax_init, 2, compute=jnp.bfloat16, seed0=20)
    f32_curve, _ = port_run(jax_init, 1, seed0=20)
    for k in TS.METRIC_KEYS:
        assert abs(port_curve[0][k] - jax_curve[0][k]) < BF16_FIRST * abs(jax_curve[0][k]), k
        for p, j in zip(port_curve, jax_curve):
            assert np.isfinite(p[k]) and abs(p[k] - j[k]) < BF16_ANY * abs(j[k]), (k, p, j)
    assert port_curve[0] != f32_curve[0]  # bf16 really ran
    for name, t in state.model.state_dict().items():
        assert not t.is_floating_point() or t.dtype == torch.float32, name
    for s in state.optimizer.state.values():
        assert s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32


def test_bf16_refine_layers_track_jax(jax_init):
    """--refine_dtype bfloat16 (the counterpart of tests/test_bc.py::
    test_refine_fc_bf16_parity in a step): RefineNet's two linear layers,
    their gradients and their Adam moments are bf16 on both sides, the rest
    f32; 2 steps within the bf16 budget of the JAX package's."""
    port_curve, state = port_run(jax_init, 2, fc=torch.bfloat16, seed0=30)
    jax_curve, jstate = jax_run(jax_init, 2, fc="bfloat16", seed0=30)
    for k in TS.METRIC_KEYS:
        assert abs(port_curve[0][k] - jax_curve[0][k]) < BF16_FIRST * abs(jax_curve[0][k]), k
        for p, j in zip(port_curve, jax_curve):
            assert np.isfinite(p[k]) and abs(p[k] - j[k]) < BF16_ANY * abs(j[k]), (k, p, j)
    for name, p in state.model.named_parameters():
        want = torch.bfloat16 if name.startswith("refine_net.fc_blocks.") else torch.float32
        assert p.dtype == want, name
        if p.grad is not None:
            s = state.optimizer.state[p]
            assert p.grad.dtype == s["exp_avg"].dtype == s["exp_avg_sq"].dtype == want, name
    assert state.model.refine_net.fc_blocks[0].weight.grad is not None
    mu = jstate.opt_state.inner_states["train"].inner_state[0].mu
    assert mu["refine_net"]["fc0"]["kernel"].dtype == jnp.bfloat16


def test_step_lr_by_epoch_matches_the_jax_cli():
    """StepLR(10, 0.5) counted in epochs (vaeplay_tpu/cli/train_bc.py:114-116),
    as the LambdaLR factor of frozen_backbone_adam's schedule, gives the
    same Adam updates, step by step, as optax driven by the JAX CLI's
    schedule."""
    iters = 2
    factor = step_lr_by_epoch(iters)
    assert [factor(s) for s in (0, 19, 20, 39, 40)] == [1.0, 1.0, 0.5, 0.5, 0.25]

    def jax_schedule(step):
        return 0.01 * (0.5 ** ((step // iters) // 10))

    w = torch.nn.Linear(1, 1, bias=False)
    torch.nn.init.constant_(w.weight, 1.0)
    state = TrainState.create(w, 0.01, factor)
    tx = optax.adam(jax_schedule)
    jw = jnp.ones((1, 1))
    opt_state = tx.init(jw)
    for s, g in enumerate(np.cos(np.arange(44, dtype=np.float32)) + 1.5):
        assert state.optimizer.param_groups[0]["lr"] == pytest.approx(float(jax_schedule(s)))
        w.weight.grad = torch.full((1, 1), float(g))
        state.apply_gradients()
        updates, opt_state = tx.update(jnp.full((1, 1), g), opt_state, jw)
        jw = optax.apply_updates(jw, updates)
        # optax takes Adam's bias corrections in f32, torch in f64
        np.testing.assert_allclose(w.weight.detach().numpy(), np.asarray(jw), rtol=2e-5)


def test_traced_step_runs_and_counts(jax_init):
    """contours=None: the step traces its own masks (one trace a step), its
    losses are finite and its predicted points lie in the padded frame."""
    _, params, stats, consts = jax_init
    port = port_model(params, stats, consts).train()
    state = frozen_backbone_adam(port, LR)
    tensors, _ = port_args(*batch(40))
    calls = TB.trace_contours.calls
    state, m = TS.make_bc_train_step(port)(state, *tensors)
    assert TB.trace_contours.calls == calls + 1 and state.step == 1
    assert all(np.isfinite(float(v)) for v in m.values())
    with torch.no_grad():
        pts = port.eval()(tensors[0])["contours"]
    assert float(pts.min()) >= 0 and float(pts.max()) <= IMG + 1


def test_state_round_trip_and_resume(jax_init, tmp_path):
    """A saved BC state restores bit for bit (model, Adam, schedule, step),
    and a resumed step equals the uninterrupted one."""
    _, params, stats, consts = jax_init

    def fresh():
        port = port_model(params, stats, consts).train()
        return frozen_backbone_adam(port, LR, schedule=step_lr_by_epoch(1))

    state = fresh()
    step = TS.make_bc_train_step(state.model)
    tensors, contours = port_args(*batch(50))
    state, _ = step(state, *tensors, contours=contours)
    ckpt = Checkpointer(str(tmp_path / "run"))
    save_state(ckpt, 0, state)
    restored, tag = restore_state(str(tmp_path / "run"), fresh())
    assert tag == 0 and restored.step == 1 and restored.scheduler.last_epoch == 1
    tensors, contours = port_args(*batch(51))
    _, m1 = step(state, *tensors, contours=contours)
    _, m2 = TS.make_bc_train_step(restored.model)(restored, *tensors, contours=contours)
    for k in TS.METRIC_KEYS:
        assert float(m1[k]) == float(m2[k]), k
    for (k, a), b in zip(state.model.state_dict().items(), restored.model.state_dict().values()):
        assert torch.equal(a, b), k
