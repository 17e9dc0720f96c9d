"""The port's BCP step (vaeplay_torch.train.steps_bcp) against the JAX
package's, on the CPU at a small size (64 px, 64 points, batch 2; G with
point attention, its encoder towers cut to 2 blocks and its map-size
constant to 32): one G forward, the D phase and the G phase of the JAX
recipe in f64 (the eight losses and both nets' gradients), three f32 steps
against make_bcp_train_step itself, D held in the G phase, bf16 against f32,
and the GanState checkpoint round trip.

The JAX step casts G's and D's outputs to f32 even under x64 (amp.to_f32),
its bilinear gather takes f32 weights and its plain attention f32 scores, so
the f64 test composes the JAX recipe from its models and losses with f64
attention, at dyadic contour points (tests/test_torch_bcp.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from vaeplay_torch.data.bcp_data import SyntheticBCPDataset
from vaeplay_torch.models import bcp as TB
from vaeplay_torch.models.convert import bcp_disc_state_dict_from_jax, bcp_state_dict_from_jax
from vaeplay_torch.train.checkpoint import Checkpointer, restore_state, save_state
from vaeplay_torch.train.state import GanState, TrainState
from vaeplay_torch.train.steps_bcp import D_KEYS, G_KEYS, METRIC_KEYS, make_bcp_train_step
from vaeplay_tpu.core import layers as JL
from vaeplay_tpu.models import bcp as JB
from vaeplay_tpu.models.torch_convert import bcp_disc_from_torch
from vaeplay_tpu.ops import losses as JLoss
from vaeplay_tpu.train.state import TrainState as JaxTrainState
from vaeplay_tpu.train.state import torch_adam
from vaeplay_tpu.train.steps_bcp import make_bcp_train_step as jax_step
from vaeplay_tpu.train.steps_be_gan import GanState as JaxGanState

IMG, P, B, BLOCKS, OUT, LR = 64, 64, 2, 2, 32, 1e-3
VW = TB.VALUE_WEIGHT
F64_TOL = 1e-9    # f64 gradients: of each tensor's largest magnitude
F32_TOL = 1e-3    # three f32 steps: the losses, relative
# ... and the weights. Adam's first steps move a weight by about lr x sign(g)
# whatever |g| is, so a gradient of rounding size, whose sign the two
# frameworks' f32 sums may give apart, moves a weight by up to 2 lr a step
# (at this size up to 2.3% of a tensor's weights end more than 1e-3 of its
# largest apart, most in the instance-norm tower): each tensor's three-step
# update (w3 - w0) is held within UPDATE_TOL of the JAX update's L2 norm,
# and every weight within 2 lr a step of JAX's
UPDATE_TOL = 0.1
# bf16 losses against f32 (tests/test_bf16.py's budget); g_adv_loss reads D
# after its first Adam step, where the same sign effect acts on every weight
# whose gradient bf16 rounding flips, so it is held at twice that
BF16_BUDGET = {k: 0.05 for k in METRIC_KEYS} | {"g_adv_loss": 0.10}
# an attention block's k bias shifts every score of a query row by the same
# amount wherever its ReLU is open, which the softmax takes out: its true
# gradient is (near) 0, so it is held to its layer's kernel gradient's scale
ZERO_GRADS = {f"line_predictor.batch_attention.{i}.k.conv.0.bias":
              f"line_predictor.batch_attention.{i}.k.conv.0.weight" for i in range(3)}


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _randomize(params, seed):
    """Every bias from +-0.2, every attention gamma from +-[0.2, 0.6]."""
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(jax.device_get(params))
    for k, v in flat.items():
        if "bias" in k[-1]:
            flat[k] = rng.uniform(-0.2, 0.2, v.shape).astype(np.float32)
        elif k[-1] == "gamma":
            flat[k] = (rng.choice([-1.0, 1.0]) * rng.uniform(0.2, 0.6, (1,))).astype(np.float32)
    return traverse_util.unflatten_dict(flat)


@pytest.fixture(scope="module")
def jax_init():
    """The slim JAX G (point attention on) and D, randomized params."""
    g = JB.ComposeNet(image_size=IMG, pt_size=P, point_attention=True, encoder_blocks=BLOCKS,
                      encoder_out_size=OUT)
    d = JB.Discriminator(image_size=IMG, pt_size=P)
    x = jnp.zeros((1, IMG, IMG, 3))
    gp = jax.jit(g.init)({"params": jax.random.PRNGKey(3)}, x, jnp.zeros((1, P, 2)),
                         jnp.ones((1,), jnp.int32))["params"]
    dp = jax.jit(d.init)({"params": jax.random.PRNGKey(4)}, x, jnp.zeros((1, P, 4)))["params"]
    return g, d, _randomize(gp, 3), _randomize(dp, 4)


def _batch(seed, dtype=np.float64):
    """Noise images, labels, points [dyadic sx, sy; offsets; triggers (about a
    third); a key every 16th] and pmask (P, P - 9 valid)."""
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(size=(B, IMG, IMG, 3))
    points = np.zeros((B, P, 6))
    points[..., :2] = rng.integers(-36, 37, (B, P, 2)) / 32.0
    points[..., 2:4] = rng.uniform(-0.3, 0.3, (B, P, 2))
    points[..., 4] = rng.uniform(size=(B, P)) < 0.35
    points[..., 5] = np.arange(P) % 16 == 0
    pmask = (np.arange(P)[None] < np.asarray([P, P - 9])[:, None]).astype(np.float64)
    points *= pmask[..., None]
    labels = np.asarray([0, 1])
    return imgs.astype(dtype), labels, points.astype(dtype), pmask.astype(dtype)


def _torch_batch(batch, dtype=torch.float64):
    imgs, labels, points, pmask = batch
    return (torch.from_numpy(np.ascontiguousarray(np.transpose(imgs, (0, 3, 1, 2)))).to(dtype),
            torch.from_numpy(labels), torch.from_numpy(points).to(dtype),
            torch.from_numpy(pmask).to(dtype))


def _port_state(jax_init, dtype=torch.float64) -> GanState:
    _, _, gp, dp = jax_init
    g = TB.ComposeNet(P, True, encoder_blocks=BLOCKS, encoder_out_size=OUT)
    g.load_state_dict(bcp_state_dict_from_jax(gp))
    d = TB.Discriminator(IMG, P)
    d.load_state_dict(bcp_disc_state_dict_from_jax(dp, IMG))
    return GanState(TrainState.create(g.to(dtype).train(), LR),
                    TrainState.create(d.to(dtype).train(), LR))


def _f64_attention(q, k, v, ring=None):
    return jnp.einsum("bnm,bmc->bnc", jax.nn.softmax(jnp.einsum("bnd,bmd->bnm", q, k), -1), v)


def _jax_recipe(g, d):
    """The JAX BCP step's two phases (steps_bcp.py:48-128) composed from its
    models and losses without the f32 casts: (d_phase, g_phase), each
    (g_params, d_params, imgs, labels, points, pmask) -> (gradients of the
    phase's net, its losses), jitted."""
    def heads(gp, imgs, points, pmask):
        counts = jnp.sum(pmask, axis=1).astype(jnp.int32)
        out = g.apply({"params": gp}, imgs, points[..., :2] * pmask[..., None], counts,
                      train=True)
        return out["classes"], out["target_pts"], out["target_frequency"]

    def fake(points, pmask, pts):
        v = pmask[..., None]
        return jnp.concatenate([points[..., :2] * v * VW, pts], axis=-1) * v

    @jax.jit
    def d_phase(gp, dp, imgs, labels, points, pmask):
        f_t = jax.lax.stop_gradient(fake(points, pmask, heads(gp, imgs, points, pmask)[1]))
        r_t = points[..., :4] * VW * pmask[..., None]

        def loss(dp):
            r = d.apply({"params": dp}, imgs, r_t, train=True)
            f = d.apply({"params": dp}, imgs, f_t, train=True)
            dr = jnp.mean(JLoss.bce(r, jnp.ones_like(r)))
            df = jnp.mean(JLoss.bce(f, jnp.zeros_like(f)))
            return (dr + df) * 0.5, {"d_adv_real": dr, "d_adv_fake": df}

        return jax.grad(loss, has_aux=True)(dp)

    @jax.jit
    def g_phase(gp, dp, imgs, labels, points, pmask):
        def loss(gp):
            cls, pts, freq = heads(gp, imgs, points, pmask)
            lc = jnp.mean(JLoss.softmax_cross_entropy(cls, labels))
            ft = (points[..., 4] > 0.1) & (pmask > 0)
            nt = (points[..., 4] <= 0.1) & (pmask > 0)
            lf1 = JLoss.masked_mean(jnp.abs(freq - 1.0), ft)
            lf0 = jnp.where(jnp.sum(nt) > 0,
                            jnp.sum(jnp.abs(freq) * nt) / jnp.maximum(jnp.sum(ft), 1), 0.0)
            diff = jnp.abs(pts - points[..., 2:4] * VW)
            lt = JLoss.masked_mean(diff, pmask[..., None])
            key = (points[..., 5] > 0.9) & (pmask > 0)
            lk = jnp.sum(jnp.sum(diff, axis=-1) * key) / jnp.maximum(jnp.sum(key), 1)
            adv = d.apply({"params": dp}, imgs, fake(points, pmask, pts), train=True)
            ga = jnp.mean(JLoss.bce(adv, jnp.ones_like(adv)))
            total = lc + (lf1 + lf0) * 4.0 + lt * 10.0 + lk * 6.0 + ga
            return total, {"loss_class": lc, "loss_frequency_one": lf1,
                           "loss_frequency_zero": lf0, "loss_total_regress": lt,
                           "loss_key_regress": lk, "g_adv_loss": ga}

        return jax.grad(loss, has_aux=True)(gp)

    return d_phase, g_phase


def _check_grads(model, want_sd, zero_grads=None):
    """Every parameter's .grad within F64_TOL of the JAX gradient's largest
    magnitude (zero_grads: held at another tensor's scale)."""
    zero_grads = zero_grads or {}
    for name, p in model.named_parameters():
        w = want_sd[name].numpy()
        assert p.grad is not None and p.grad.dtype == torch.float64, name
        scale = np.abs(want_sd[zero_grads.get(name, name)].numpy()).max()
        assert scale > 0, name
        np.testing.assert_allclose(p.grad.numpy(), w, atol=F64_TOL * scale, rtol=0, err_msg=name)


def test_f64_d_phase_then_g_phase_match_jax(jax_init, monkeypatch):
    """One shared G forward; the D phase's two losses within 1e-10 relative
    and D's every gradient within 1e-9 of its largest against the JAX
    recipe; then the G phase against the D that the port's Adam stepped (its
    weights taken into the JAX recipe): its six losses, and G's every
    gradient, point attention included. The G phase leaves D's weights and
    D's gradients as the D phase left them."""
    g, d, gp, dp = jax_init
    batch = _batch(5)
    gs = _port_state(jax_init)
    step = make_bcp_train_step(gs.g.model, gs.d.model)
    tb = _torch_batch(batch)
    preds = step.forward(*tb)
    gs, dm = step.d_phase(gs, preds, *tb)
    assert sorted(dm) == sorted(D_KEYS) and gs.d.step == 1 and gs.g.step == 0
    d_after = {k: v.clone() for k, v in gs.d.model.state_dict().items()}
    d_grads = {k: p.grad.clone() for k, p in gs.d.model.named_parameters()}
    gs, gm = step.g_phase(gs, preds, *tb)
    assert sorted(gm) == sorted(G_KEYS) and gs.g.step == 1

    monkeypatch.setattr(JL, "spatial_self_attention", _f64_attention)
    d_phase, g_phase = _jax_recipe(g, d)
    new_dp = bcp_disc_from_torch({k: v.numpy() for k, v in d_after.items()}, IMG)
    with jax.enable_x64(True):
        c64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
        args = [jnp.asarray(a) for a in batch]
        jd_grads, jdm = jax.device_get(d_phase(c64(gp), c64(dp), *args))
        jg_grads, jgm = jax.device_get(g_phase(c64(gp), c64(new_dp), *args))
    for m, jm in ((dm, jdm), (gm, jgm)):
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-10, err_msg=k)
    for k, p in gs.d.model.named_parameters():
        p.grad = d_grads[k]
    _check_grads(gs.d.model, bcp_disc_state_dict_from_jax(jd_grads, IMG))
    _check_grads(gs.g.model, bcp_state_dict_from_jax(jg_grads), ZERO_GRADS)
    for k, v in gs.d.model.state_dict().items():
        assert torch.equal(v, d_after[k]), k


def _jax_gan_state(jax_init) -> JaxGanState:
    g, d, gp, dp = jax_init
    return JaxGanState(g=JaxTrainState.create(g.apply, gp, None, torch_adam(LR)),
                       d=JaxTrainState.create(d.apply, dp, None, torch_adam(LR)))


def test_f32_steps_track_jax_step(jax_init):
    """Three f32 steps of the JAX package's make_bcp_train_step (its f32
    casts and plain f32 attention) and of the port's from the same weights
    on the same synthetic batches: the eight losses of each step within 1e-3
    relative; each tensor's update over the three steps within UPDATE_TOL of
    the JAX update's norm, and every weight within 2 lr a step of JAX's (a
    flipped Adam update)."""
    ds = SyntheticBCPDataset(img_size=IMG, max_points=P, data_size=3 * B)
    batches = [(b["imgs"], b["labels"], b["points"], b["pmask"]) for b in ds.epoch_batches(B)]
    gs = _port_state(jax_init, torch.float32)
    start = {k: v.clone().numpy() for m in (gs.g.model, gs.d.model)
             for k, v in m.state_dict().items()}
    step = make_bcp_train_step(gs.g.model, gs.d.model)
    jgs, jstep = _jax_gan_state(jax_init), jax_step(*jax_init[:2])
    for i, b in enumerate(batches):
        gs, m = step(gs, *_torch_batch(b, torch.float32))
        jgs, jm = jstep(jgs, *map(jnp.asarray, b))
        assert list(m) == list(METRIC_KEYS)
        for k in METRIC_KEYS:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=F32_TOL,
                                       err_msg=f"step {i} {k}")
    for model, want in ((gs.g.model, bcp_state_dict_from_jax(jax.device_get(jgs.g.params))),
                        (gs.d.model, bcp_disc_state_dict_from_jax(jax.device_get(jgs.d.params),
                                                                  IMG))):
        for k, v in model.state_dict().items():
            w = want[k].numpy()
            off = np.linalg.norm(v.numpy() - w) / np.linalg.norm(w - start[k])
            assert off <= UPDATE_TOL and np.abs(v.numpy() - w).max() <= 2 * LR * len(batches), (
                k, float(off))
    assert gs.g.step == gs.d.step == 3


def test_one_g_forward_a_step():
    """G runs once a step: the D phase reads the same forward's outputs,
    detached (the reference's second, identical forward is shared)."""
    g = TB.ComposeNet(P, encoder_blocks=BLOCKS, encoder_out_size=OUT,
                      generator=torch.Generator().manual_seed(0))
    d = TB.Discriminator(IMG, P, generator=torch.Generator().manual_seed(1))
    calls = []
    g.register_forward_hook(lambda *a: calls.append(1))
    gs = GanState(TrainState.create(g, LR), TrainState.create(d, LR))
    gs, m = make_bcp_train_step(g, d)(gs, *_torch_batch(_batch(6), torch.float32))
    assert len(calls) == 1 and all(bool(torch.isfinite(v)) for v in m.values())


def test_bf16_step_keeps_f32_state(jax_init):
    """Under bf16 autocast (D's sigmoid and every BCE in f32) the eight losses
    are finite and within BF16_BUDGET of the f32 step's; parameters,
    gradients and Adam's moments stay f32."""
    batch = _torch_batch(_batch(7), torch.float32)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        gs = _port_state(jax_init, torch.float32)
        gs, m = make_bcp_train_step(gs.g.model, gs.d.model, dtype)(gs, *batch)
        out[dtype] = {k: float(v) for k, v in m.items()}
    for k in METRIC_KEYS:
        f32, bf16 = out[torch.float32][k], out[torch.bfloat16][k]
        assert np.isfinite(bf16) and abs(bf16 - f32) < BF16_BUDGET[k] * abs(f32), (k, f32, bf16)
    assert out[torch.float32] != out[torch.bfloat16]
    for state in (gs.g, gs.d):
        for name, p in state.model.named_parameters():
            assert p.dtype == p.grad.dtype == torch.float32, name
        for s in state.optimizer.state.values():
            assert s["exp_avg"].dtype == s["exp_avg_sq"].dtype == torch.float32


def test_gan_state_round_trip_and_resume(jax_init, tmp_path):
    """A GanState saved after a step restores whole into a fresh one, and the
    next step equals a run that never stopped."""
    batches = [_torch_batch(_batch(8 + i), torch.float32) for i in range(2)]
    gs = _port_state(jax_init, torch.float32)
    step = make_bcp_train_step(gs.g.model, gs.d.model)
    gs, _ = step(gs, *batches[0])
    save_state(Checkpointer(str(tmp_path)), 0, gs)
    _, straight = step(gs, *batches[1])
    resumed, tag = restore_state(str(tmp_path), _port_state(jax_init, torch.float32))
    assert tag == 0 and resumed.g.step == resumed.d.step == 1
    _, m = make_bcp_train_step(resumed.g.model, resumed.d.model)(resumed, *batches[1])
    assert {k: float(v) for k, v in m.items()} == {k: float(v) for k, v in straight.items()}
