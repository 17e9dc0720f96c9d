"""The port's BE training (vaeplay_torch.train.steps_be, frozen_backbone_adam,
the bf16 autocast policy) against the JAX package's, on the CPU at a small
size (the (1, 1, 1, 1) x 16 backbone, 64 px, batch 2): a 3-step f32
trajectory against make_be_train_step, bf16 against the port's own f32, the
on-device bubble step, the eval step, and the checkpoint round trip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from vaeplay_torch.data.be_data import (SyntheticBubbleDataset, render_bubble_batch,
                                        sample_bubble_params)
from vaeplay_torch.models import be as TBE
from vaeplay_torch.models.convert import be_state_dict_from_jax
from vaeplay_torch.train import steps_be as TS
from vaeplay_torch.train.checkpoint import Checkpointer, restore_state, save_state
from vaeplay_torch.train.state import frozen_backbone_adam, is_frozen_backbone_param
from vaeplay_tpu.models.be import ComposeNet
from vaeplay_tpu.train.state import TrainState as JaxTrainState
from vaeplay_tpu.train.state import frozen_backbone_adam as jax_frozen_backbone_adam
from vaeplay_tpu.train.steps_be import make_be_eval_step as jax_eval_step
from vaeplay_tpu.train.steps_be import make_be_train_step as jax_train_step

SLIM, WIDTH, IMG, B, LR = (1, 1, 1, 1), 16, 64, 2, 1e-4
# f32 trajectory: each step's losses within 2e-5 relative of JAX's. Both
# start from the same weights; Adam's first steps move every weight by about
# lr x sign(g), so a rounding-sized gradient whose sign differs moves a weight
# by up to 2 lr between the frameworks, which the later losses feel far below
# this bound.
TRAJ_RTOL = 2e-5


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
    """The slim JAX ComposeNet's init with its FrozenBatchNorm constants drawn
    (scale in [0.3, 0.8], bias and mean in +-0.1, var in [0.5, 1.5])."""
    model = ComposeNet(backbone_layers=SLIM, backbone_width=WIDTH)
    v = jax.device_get(jax.jit(model.init)({"params": jax.random.PRNGKey(1)},
                                           jnp.zeros((1, IMG, IMG, 3))))
    rng = np.random.default_rng(1)
    consts = traverse_util.flatten_dict(v["constants"])
    ranges = {"scale": (0.3, 0.8), "bias": (-0.1, 0.1), "mean": (-0.1, 0.1), "var": (0.5, 1.5)}
    for k in consts:
        consts[k] = rng.uniform(*ranges[k[-1]], consts[k].shape).astype(np.float32)
    return model, v["params"], v["batch_stats"], traverse_util.unflatten_dict(consts)


def _port(params, stats, consts) -> TBE.ComposeNet:
    port = TBE.ComposeNet(SLIM, WIDTH)
    port.load_state_dict(be_state_dict_from_jax(params, stats, consts))
    return port.train()


def _batch(seed):
    """Noise images (no exact zeros at the ReLUs) and bubble masks, NCHW."""
    imgs = torch.from_numpy(np.random.default_rng(seed).uniform(
        size=(B, 3, IMG, IMG)).astype(np.float32))
    _, bimgs, eimgs = render_bubble_batch(IMG, torch.from_numpy(
        sample_bubble_params(IMG, B, seed=seed)[0]))
    return imgs, bimgs, eimgs


def _nhwc(t: torch.Tensor):
    return jnp.asarray(t.permute(0, 2, 3, 1).numpy())


def _port_run(jax_init, steps, dtype=torch.float32, seed0=10):
    """`steps` port steps from the JAX init; the losses per step and the state."""
    _, params, stats, consts = jax_init
    port = _port(params, stats, consts)
    state, step = frozen_backbone_adam(port, LR), TS.make_be_train_step(port, dtype)
    out = []
    for i in range(steps):
        state, m = step(state, *_batch(seed0 + i))
        out.append({k: float(v) for k, v in m.items()})
    return out, state


def test_f32_trajectory_tracks_jax(jax_init):
    """3 f32 steps on the same batches as the JAX package's
    make_be_train_step with frozen_backbone_adam: each step's two losses
    within TRAJ_RTOL; both leave the frozen stem and layer1 as they were."""
    model, params, stats, consts = jax_init
    port_curve, state = _port_run(jax_init, 3)
    jstate = JaxTrainState.create(model.apply, params, stats, jax_frozen_backbone_adam(LR),
                                  constants=consts)
    jstep = jax_train_step(model)
    jax_curve = []
    for i in range(3):
        jstate, jm = jstep(jstate, *map(_nhwc, _batch(10 + i)))
        jax_curve.append({k: float(v) for k, v in jm.items()})
    for p, j in zip(port_curve, jax_curve):
        for k in TS.METRIC_KEYS:
            np.testing.assert_allclose(p[k], j[k], rtol=TRAJ_RTOL, err_msg=f"{k}: {port_curve} "
                                                                           f"vs {jax_curve}")
    assert port_curve[0] != port_curve[2]  # the weights moved
    stem = state.model.feature_net.backbone.body.conv1.weight.detach().numpy()
    np.testing.assert_array_equal(np.transpose(stem, (2, 3, 1, 0)),
                                  params["feature_net"]["backbone"]["body"]["conv1"]["kernel"])
    np.testing.assert_array_equal(
        jax.device_get(jstate.params["feature_net"]["backbone"]["body"]["conv1"]["kernel"]),
        params["feature_net"]["backbone"]["body"]["conv1"]["kernel"])


def test_bf16_tracks_f32_and_keeps_f32_state(jax_init):
    """The bf16 autocast policy against the port's own f32 over 3 steps: the
    first step's losses (identical weights) within 2% relative, every step
    within 5% and finite (tests/test_bf16.py's budget for the JAX package).
    Parameters, their gradients, Adam's moments and every buffer (BN and
    FrozenBatchNorm) stay f32."""
    f32, _ = _port_run(jax_init, 3, seed0=20)
    bf16, state = _port_run(jax_init, 3, torch.bfloat16, seed0=20)
    for k in TS.METRIC_KEYS:
        assert abs(bf16[0][k] - f32[0][k]) < 0.02 * abs(f32[0][k]), (k, bf16[0], f32[0])
        for s16, s32 in zip(bf16, f32):
            assert np.isfinite(s16[k]) and abs(s16[k] - s32[k]) < 0.05 * abs(s32[k]), (k, s16, s32)
    assert bf16[0] != f32[0]  # bf16 really ran
    for name, t in state.model.state_dict().items():
        assert not t.is_floating_point() or t.dtype == torch.float32, name
    for p in state.model.parameters():
        assert p.grad is None or p.grad.dtype == torch.float32
    for s in state.optimizer.state.values():
        assert s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32


def test_frozen_backbone_adam_holds_only_trainable_tensors(jax_init):
    """torchvision's trainable_layers=3: body.conv1 and body.layer1 stop
    requiring a gradient and are not in Adam's groups; everything else is.
    A model with no backbone is refused."""
    _, params, stats, consts = jax_init
    port = _port(params, stats, consts)
    state = frozen_backbone_adam(port, LR)
    in_adam = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    for name, p in port.named_parameters():
        frozen = ".body.conv1." in name or ".body.layer1." in name
        assert is_frozen_backbone_param(name) == frozen and p.requires_grad != frozen, name
        assert (id(p) in in_adam) != frozen, name
    assert state.optimizer.param_groups[0]["betas"] == (0.9, 0.999)
    assert state.optimizer.param_groups[0]["eps"] == 1e-8
    with pytest.raises(ValueError, match="no backbone"):
        frozen_backbone_adam(torch.nn.Linear(2, 2), LR)


def test_bubble_step_equals_step_on_host_batch(jax_init):
    """make_bubble_train_step renders the table and augments on the device;
    the same step on SyntheticBubbleDataset's host batch, augmented with the
    same draws, gives the same losses, gradients, weights and BN buffers,
    bit for bit."""
    _, params, stats, consts = jax_init
    ds = SyntheticBubbleDataset(img_size=IMG, data_size=B, seed=6)
    (table, _), host = next(ds.epoch_params(B)), next(ds.epoch_batches(B))
    a, b = _port(params, stats, consts), _port(params, stats, consts)
    _, ma = TS.make_bubble_train_step(a, IMG)(frozen_backbone_adam(a, LR), torch.from_numpy(table),
                                              torch.Generator().manual_seed(7))
    nchw = [torch.from_numpy(host[k]).permute(0, 3, 1, 2).contiguous()
            for k in ("imgs", "bimgs", "eimgs")]
    augmented = TS.augment(*nchw, torch.Generator().manual_seed(7))
    _, mb = TS.make_be_train_step(b)(frozen_backbone_adam(b, LR), *augmented)
    for k in TS.METRIC_KEYS:
        assert torch.equal(ma[k], mb[k]), k
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
        assert (pa.grad is None) == (pb.grad is None) and (pa.grad is None or torch.equal(
            pa.grad, pb.grad)), name
    for (name, ba), bb in zip(a.named_buffers(), b.buffers()):
        assert torch.equal(ba, bb), name


def test_eval_step_matches_jax(jax_init):
    """Sigmoid maps of the eval-mode forward (running statistics) within 1e-5;
    the model's train mode is restored."""
    model, params, stats, consts = jax_init
    port = _port(params, stats, consts)
    imgs = _batch(30)[0]
    got = TS.make_be_eval_step(port)(imgs)
    assert port.training
    jstate = JaxTrainState.create(model.apply, params, stats, jax_frozen_backbone_adam(LR),
                                  constants=consts)
    want = jax_eval_step(model)(jstate, _nhwc(imgs))
    for k in ("edges", "masks"):
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


def test_state_round_trip_and_resume(jax_init, tmp_path):
    """A state saved after a step restores into a fresh model and optimizer
    (strictly: the model's keys, Adam's groups) and the next step equals a
    run that never stopped; a checkpoint of another model is refused."""
    _, params, stats, consts = jax_init
    straight, _ = _port_run(jax_init, 2, seed0=40)
    _, first = _port_run(jax_init, 1, seed0=40)
    save_state(Checkpointer(str(tmp_path)), 0, first)
    port = _port(params, stats, consts)
    resumed, tag = restore_state(str(tmp_path), frozen_backbone_adam(port, LR))
    assert tag == 0 and resumed.step == 1
    for (name, a), b in zip(first.model.state_dict().items(), port.state_dict().values()):
        assert torch.equal(a, b), name
    _, m = TS.make_be_train_step(port)(resumed, *_batch(41))
    assert {k: float(v) for k, v in m.items()} == straight[1]
    other = TBE.ComposeNet((1, 1, 1, 1), 8)
    with pytest.raises(RuntimeError, match="size mismatch"):
        restore_state(str(tmp_path), frozen_backbone_adam(other, LR))
