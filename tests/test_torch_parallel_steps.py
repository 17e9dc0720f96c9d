"""The port's train steps on a mesh (2- and 1x2-rank gloo worlds) against
the same steps on one rank, in f64 at 1e-9: VAE-GAN over "data" (BatchNorm
over the global batch, global noise and sums) and with FSDP2 over "model",
BCP over "data" with the ranks' point counts unequal (the masked means) and
with its point attention as a ring over "model", BC through the bridge
(sync); and the VAE-GAN's 2x1 f32 step against the JAX package's step on a
2-device mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as Pspec

import torch_dist_workers as W
from vaeplay_torch.data.bc_data import SyntheticBCDataset
from vaeplay_torch.data.bcp_data import SyntheticBCPDataset
from vaeplay_torch.models import bc as TBC
from vaeplay_torch.models import bcp as TBCP
from vaeplay_torch.models import vae_gan as TV
from vaeplay_torch.models.convert import vaegan_state_dict_from_jax
from vaeplay_torch.train import steps_vae as TS
from vaeplay_torch.train.state import GanState, TrainState, frozen_backbone_adam
from vaeplay_torch.train.steps_bc import BridgeTracer, make_bc_mask_step, make_bc_train_step
from vaeplay_torch.train.steps_bcp import make_bcp_train_step
from vaeplay_tpu.models.vae_gan import VaeGan
from vaeplay_tpu.parallel.mesh import create_mesh, replicate
from vaeplay_tpu.train.state import TrainState as JaxTrainState
from vaeplay_tpu.train.state import grouped_transform
from vaeplay_tpu.train.state import torch_rmsprop as jax_rmsprop
from vaeplay_tpu.train.steps_vae import vae_gan_losses as jax_losses

TOL = 1e-9  # f64: of each tensor's largest magnitude
F32_TOL = 1e-3  # the f32 step 0 against JAX, relative (tests/test_torch_train_vae.py)
IMG, Z, B, LR = 32, 32, 4, 1e-4


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close_trees(got, want, what):
    assert sorted(got) == sorted(want), what
    for k, w in want.items():
        if not torch.is_floating_point(w):
            assert torch.equal(got[k], w), (what, k)
            continue
        scale = max(float(w.abs().max()), 1e-30)
        assert float((got[k] - w).abs().max()) <= TOL * scale, (what, k)


def _close_metrics(ranks, want):
    """Each metric's mean over the ranks is the one-rank run's."""
    for k, w in want.items():
        got = np.mean([r[k] for r in ranks])
        np.testing.assert_allclose(got, w, rtol=TOL, atol=1e-300, err_msg=k)


# -- VAE-GAN ------------------------------------------------------------------

@pytest.fixture(scope="module")
def vae_jax():
    model = VaeGan(img_size=IMG, z_size=Z)
    v = jax.jit(model.init)({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                            jnp.zeros((2, IMG, IMG, 1)))
    return model, jax.device_get(v["params"]), jax.device_get(v["batch_stats"])


def _vae_batch(seed, dtype):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(size=(B, 1, IMG, IMG)).astype(dtype)
    return imgs, (rng.normal(size=(B, 3)) * 0.5).astype(dtype)


def _vae_one_rank(sd, imgs, targets, seed, steps):
    from vaeplay_torch.cli.train_vae import build_state

    state = build_state(IMG, Z, LR, 0, torch.device("cpu"))
    state.model.double().load_state_dict(sd)
    step = TS.make_train_step(state.model)
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(steps):
        state, m = step(state, torch.from_numpy(imgs), torch.from_numpy(targets), gen)
        out.append({k: float(v) for k, v in m.items()})
    return out, state.model.state_dict(), {n: p.grad for n, p in state.model.named_parameters()}


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_vae_mesh_steps_equal_one_rank(tmp_path, vae_jax, shape):
    """2x1: each rank its half of the batch, BatchNorm over the global batch;
    1x2: the weights and RMSprop state sharded over "model" by FSDP2. Two
    steps: the losses of both, and after the second the gradients, BN
    buffers and weights, each weight also within RMSprop's slope times its
    gradients' difference (lr / 1e-8 at g = 0, as
    tests/test_torch_train_vae.py bounds the step against JAX)."""
    _, params, stats = vae_jax
    sd = {k: v.double() for k, v in vaegan_state_dict_from_jax(params, stats, IMG).items()}
    imgs, targets = _vae_batch(3, np.float64)
    want_m, want_sd, want_g = _vae_one_rank(sd, imgs, targets, 5, 2)
    ranks = W.run_world(W.vae_step, 2, tmp_path, shape, {"z": Z, "sd": sd}, imgs, targets, 5, 2)
    for i in range(2):
        _close_metrics([r["metrics"][i] for r in ranks], want_m[i])
    for r in ranks:
        _close_trees(r["grads"], want_g, f"mesh {shape} gradient")
        _close_trees({k: v for k, v in r["sd"].items() if k not in want_g},
                     {k: v for k, v in want_sd.items() if k not in want_g}, f"mesh {shape} buffer")
        for k, g in want_g.items():
            bound = (TOL * float(want_sd[k].abs().max())
                     + 2.002 * LR / 1e-8 * (r["grads"][k] - g).abs())
            assert ((r["sd"][k] - want_sd[k]).abs() <= bound).all(), (shape, k)


def test_vae_2x1_f32_step_matches_jax_mesh_step(tmp_path, vae_jax):
    """The port's 2-rank f32 step against the JAX step on a 2x1 mesh of
    virtual devices (GSPMD: BatchNorm and losses over the global batch),
    the same weights, batch and noise: losses at the f32 step-0 tolerance."""
    model, params, stats = vae_jax
    sd = vaegan_state_dict_from_jax(params, stats, IMG)
    imgs, targets = _vae_batch(4, np.float32)
    eps, z_p = TV.VaeGan(img_size=IMG, z_size=Z).draw_noise(
        B, torch.Generator().manual_seed(6), torch.device("cpu"))
    mesh = create_mesh(n_data=2, n_model=1, devices=jax.devices()[:2])
    rows = NamedSharding(mesh, Pspec("data"))
    tx = grouped_transform({g: jax_rmsprop(LR) for g in TS.GROUPS}, params)
    jstate = replicate(mesh, JaxTrainState.create(model.apply, params, stats, tx))

    def loss_fn(p, bs, x, t, e, zp):
        outs, mut = model.apply({"params": p, "batch_stats": bs}, x, train=True,
                                noise=(e, zp), mutable=["batch_stats"])
        m = jax_losses(outs, x, t)
        return (m["loss_recon"] + m["loss_encoder"] + m["loss_decoder"]
                + m["loss_discriminator"] + m["loss_aux"]), m

    x, t, e, zp = (jax.device_put(jnp.asarray(a), rows) for a in (
        np.transpose(imgs, (0, 2, 3, 1)), targets, eps.numpy(), z_p.numpy()))
    _, jm = jax.jit(jax.grad(loss_fn, has_aux=True))(jstate.params, jstate.batch_stats,
                                                      x, t, e, zp)
    ranks = W.run_world(W.vae_step, 2, tmp_path, (2, 1), {"z": Z, "sd": {
        k: v.double() for k, v in sd.items()}}, imgs.astype(np.float64),
        targets.astype(np.float64), 6, 1, torch.float32)
    for k in TS.METRIC_KEYS:
        got = np.mean([r["metrics"][0][k] for r in ranks])
        np.testing.assert_allclose(got, float(jm[k]), rtol=F32_TOL, err_msg=k)


# -- BCP ----------------------------------------------------------------------

BCP_IMG, BCP_P, BCP_OUT = 64, 64, 32


@pytest.fixture(scope="module")
def bcp_setup():
    g = TBCP.ComposeNet(BCP_P, True, encoder_blocks=2, encoder_out_size=BCP_OUT,
                        generator=torch.Generator().manual_seed(0)).double()
    with torch.no_grad():  # attention switched on: gamma starts at 0
        for blk in g.line_predictor.batch_attention:
            blk.gamma.fill_(0.5)
    d = TBCP.Discriminator(BCP_IMG, BCP_P, generator=torch.Generator().manual_seed(1)).double()
    batch = SyntheticBCPDataset(img_size=BCP_IMG, max_points=BCP_P, data_size=4).sample_batch(4)
    batch["pmask"][0, 40:] = 0  # rank 0's first sample holds 40 points, its second 52
    batch["pmask"][1, 52:] = 0
    counts = batch["pmask"].sum(1)
    assert counts[:2].sum() != counts[2:].sum()  # the two ranks' point counts differ
    return {"cfg": {"points": BCP_P, "out_size": BCP_OUT, "img": BCP_IMG, "min_n": 16},
            "g": g.state_dict(), "d": d.state_dict()}, batch


def _bcp_one_rank(sds, batch, point_attention, compute_dtype=None):
    """bcp_step's work on one rank: (metrics, G's weights, D's weights, G's
    gradients)."""
    cfg = sds["cfg"]
    dtype = torch.float64 if compute_dtype is None else torch.float32
    g = TBCP.ComposeNet(cfg["points"], point_attention, encoder_blocks=2,
                        encoder_out_size=cfg["out_size"]).to(dtype)
    d = TBCP.Discriminator(cfg["img"], cfg["points"]).to(dtype)
    g.load_state_dict(sds["g"])
    d.load_state_dict(sds["d"])
    gs = GanState(TrainState.create(g, 1e-3), TrainState.create(d, 1e-3))
    args = [torch.from_numpy(batch[k]) for k in ("imgs", "labels", "points", "pmask")]
    args[0] = args[0].permute(0, 3, 1, 2).contiguous().to(dtype)
    args[2], args[3] = args[2].to(dtype), args[3].to(dtype)
    gs, m = make_bcp_train_step(g, d, compute_dtype or torch.float32)(gs, *args)
    return ({k: float(v) for k, v in m.items()}, g.state_dict(), d.state_dict(),
            {n: p.grad for n, p in g.named_parameters()})


@pytest.mark.parametrize("shape,point_attention", [((2, 1), False), ((1, 2), True)])
def test_bcp_mesh_step_equals_one_rank(tmp_path, bcp_setup, shape, point_attention):
    """2x1 with unequal point counts: the masked means over the global batch;
    1x2 with --point_attention: the ring over the two model ranks."""
    sds, batch = bcp_setup
    if not point_attention:
        sds = dict(sds, g={k: v for k, v in sds["g"].items() if "batch_attention" not in k})
    want_m, want_g, want_d, _ = _bcp_one_rank(sds, batch, point_attention)
    ranks = W.run_world(W.bcp_step, 2, tmp_path, shape, sds, batch, point_attention)
    _close_metrics([r["metrics"] for r in ranks], want_m)
    for r in ranks:
        _close_trees(r["g"], want_g, "G")
        _close_trees(r["d"], want_d, "D")


BF16_METRIC_RTOL = 2e-3  # bf16 rounding of the rest of the net, relative
BF16_GRAD_TOL = 3e-2  # of each gradient's largest magnitude


def test_bcp_1x2_bf16_ring_step_equals_one_rank(tmp_path, bcp_setup, monkeypatch):
    """--dtype bfloat16 --point_attention on a 1x2 mesh: the ring runs inside
    G's bf16 autocast and computes in f32 in both passes, its probabilities
    included, so the step's metrics and G's synced gradients are the one-rank
    bf16 step's up to bf16 rounding when that step's attention computes so
    too. (The one-rank plain attention rounds the probabilities of bf16
    operands to bf16 before P.V, as JAX's and the bf16 kernel do; the ring
    keeps them in f32, so the reference here widens q, k, v first. A ring
    whose forward took autocast's bf16 products, with its backward in f32,
    is off by 4e-3 in g_adv_loss and 1e-1 in the gradients on this batch.)"""
    from vaeplay_torch.ops import attention

    plain = attention.reference_attention
    monkeypatch.setattr(attention, "reference_attention",
                        lambda q, k, v: plain(q.float(), k.float(), v.float()).to(v.dtype))
    sds, batch = bcp_setup
    sds = dict(sds, g={k: v.float() for k, v in sds["g"].items()},
               d={k: v.float() for k, v in sds["d"].items()})
    want_m, _, _, want_grads = _bcp_one_rank(sds, batch, True, torch.bfloat16)
    monkeypatch.undo()
    ranks = W.run_world(W.bcp_step, 2, tmp_path, (1, 2), sds, batch, True, torch.bfloat16)
    for k, w in want_m.items():
        got = np.mean([r["metrics"][k] for r in ranks])
        np.testing.assert_allclose(got, w, rtol=BF16_METRIC_RTOL, err_msg=k)
    for r in ranks:
        for n, w in want_grads.items():
            assert w.dtype == torch.float32
            err = float((r["g_grads"][n] - w).abs().max())
            assert err <= BF16_GRAD_TOL * float(w.abs().max()), (n, err)


# -- BC -----------------------------------------------------------------------

BC_IMG, BC_MP, BC_WIDTH = 64, 16, 16


def test_bc_bridge_2x1_step_equals_one_rank(tmp_path):
    """One sync bridge step (stride 1) on two data ranks, each tracing its
    rows, against the same step on one rank: contours, losses, weights and
    the heads' BatchNorm buffers (statistics over the global batch)."""
    model = TBC.ComposeNet(BC_MP, backbone_layers=(1, 1, 1, 1), backbone_width=BC_WIDTH,
                           generator=torch.Generator().manual_seed(2)).double()
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    batch = SyntheticBCDataset(img_size=BC_IMG, max_points=BC_MP, data_size=4).sample_batch(4)
    cfg = {"points": BC_MP, "width": BC_WIDTH}
    state = frozen_backbone_adam(model, 1e-4)
    model.train()
    nchw = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2).contiguous().double()
    t = [nchw(batch["imgs"]), nchw(batch["bimgs"]), nchw(batch["eimgs"])] + [
        torch.from_numpy(np.ascontiguousarray(batch[k])) for k in (
            "tgt_pts", "tgt_mask", "key_pts", "key_mask")]
    t[3:] = [x.double() if x.is_floating_point() else x for x in t[3:]]
    tracer = BridgeTracer(BC_IMG, 1, BC_MP)
    pts, counts = tracer.submit(make_bc_mask_step(model, 1)(state, t[0])).result()
    assert counts.min() > 0
    state, m = make_bc_train_step(model)(state, *t, (torch.from_numpy(pts).double(),
                                                     torch.from_numpy(counts)))
    ranks = W.run_world(W.bc_bridge_step, 2, tmp_path, (2, 1), cfg, sd, batch, 1)
    np.testing.assert_array_equal(np.concatenate([r["pts"] for r in ranks]), pts)
    np.testing.assert_array_equal(np.concatenate([r["counts"] for r in ranks]), counts)
    _close_metrics([r["metrics"] for r in ranks], {k: float(v) for k, v in m.items()})
    for r in ranks:
        _close_trees(r["sd"], model.state_dict(), "BC")
