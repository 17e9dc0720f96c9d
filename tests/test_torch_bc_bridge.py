"""BC's two-program bridge in the port (vaeplay_torch.train.steps_bc:
make_bc_mask_step, strided_mask_width, BridgeTracer; cli/train_bc.run_epoch;
eval/serve.pipeline_bc_batches) against the JAX package's, at the BC files'
small size (the (1, 1, 1, 1) x 16 backbone, 64 px, batch 2, 16 points)."""

import copy
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bc import IMG, MP, SLIM, WIDTH, nchw, port_model, randomize
from test_torch_train_bc import LR, TRAJ_RTOL, batch
from vaeplay_torch.cli.train_bc import run_epoch
from vaeplay_torch.data.bc_data import SyntheticBCDataset
from vaeplay_torch.eval.serve import pipeline_bc_batches
from vaeplay_torch.ops.bits import pack_mask_bits
from vaeplay_torch.train import steps_bc as TS
from vaeplay_torch.train.metrics import accumulating
from vaeplay_torch.train.state import frozen_backbone_adam
from vaeplay_tpu.models import bc as JB
from vaeplay_tpu.train import steps_bc as JS
from vaeplay_tpu.train.state import TrainState as JaxTrainState
from vaeplay_tpu.train.state import frozen_backbone_adam as jax_frozen_backbone_adam

THRESHOLD_MARGIN = 1e-6  # mask probabilities this close to 0.5 may round either way


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_init():
    """The slim JAX ComposeNet's init, randomized as the BC files do."""
    model = JB.ComposeNet(max_points=MP, backbone_layers=SLIM, backbone_width=WIDTH)
    pts = np.zeros((1, MP, 2), np.float32)
    v = jax.device_get(jax.jit(lambda x: model.init(
        {"params": jax.random.PRNGKey(2)}, x, contours=(pts, np.full((1,), MP, np.int32))))(
        jnp.zeros((1, IMG, IMG, 3))))
    return (model, *randomize(v, seed=1))


def _jax_state(jax_init):
    model, params, stats, consts = jax_init
    return JaxTrainState.create(model.apply, params, stats, jax_frozen_backbone_adam(LR),
                                constants=consts)


def _tensors(b):
    return (nchw(b["imgs"]), nchw(b["bimgs"]), nchw(b["eimgs"]),
            *(torch.from_numpy(b[k]) for k in TS.TARGET_KEYS[2:]))


@pytest.mark.parametrize("img_size", [64, 256, 510])
@pytest.mark.parametrize("stride", [1, 2, 3, 4])
def test_strided_mask_width_matches_jax(img_size, stride):
    assert TS.strided_mask_width(img_size, stride) == JS.strided_mask_width(img_size, stride)


@pytest.mark.parametrize("stride", [1, 4])
def test_tracer_matches_jax(stride):
    """The same packed masks (the synthetic bubbles' at the stride) traced
    by both tracers: identical points and counts, scaled by the stride."""
    bimgs = SyntheticBCDataset(img_size=IMG, max_points=MP, data_size=3).sample_batch(3)["bimgs"]
    padded = np.pad(bimgs[..., 0] > 0.5, ((0, 0), (1, 1), (1, 1)))[:, ::stride, ::stride]
    packed = pack_mask_bits(torch.from_numpy(padded))
    port = TS.BridgeTracer(IMG, stride, MP)
    got = port.submit(packed).result()
    want = JS.BridgeTracer(IMG, stride, MP).trace(packed.numpy())
    port.close()
    assert got[1].min() > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_submit_of_a_card_tensor_traces_its_copy():
    """On the card, submit queues the packed mask's copy on the caller's
    thread and the worker traces it once it lands: the same contours as a
    blocking trace of the host array."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bimgs = SyntheticBCDataset(img_size=IMG, max_points=MP, data_size=2).sample_batch(2)["bimgs"]
    packed = pack_mask_bits(torch.from_numpy(np.pad(bimgs[..., 0] > 0.5, ((0, 0), (1, 1), (1, 1)))))
    tracer = TS.BridgeTracer(IMG, 1, MP)
    got = tracer.submit(packed.cuda()).result()
    want = tracer.trace(packed.numpy())
    tracer.close()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("stride", [1, 4])
def test_mask_step_bits_match_jax(jax_init, stride):
    """make_bc_mask_step's packed bits against the JAX mask step's, on every
    pixel whose probability is further than THRESHOLD_MARGIN from 0.5
    (train-mode statistics on both); the running statistics stay as they
    were."""
    model, params, stats, consts = jax_init
    imgs = batch(3)[0]["imgs"]
    want = np.asarray(JS.make_bc_mask_step(model, stride=stride)(_jax_state(jax_init),
                                                                  jnp.asarray(imgs)))
    port = port_model(params, stats, consts).train()
    buffers = {k: v.clone() for k, v in port.state_dict().items() if "running" in k}
    state = frozen_backbone_adam(port, LR)
    got = TS.make_bc_mask_step(port, stride)(state, nchw(imgs))
    assert all(torch.equal(v, port.state_dict()[k]) for k, v in buffers.items())
    assert got.dtype == torch.uint8 and got.shape == want.shape
    width = TS.strided_mask_width(IMG, stride)
    with torch.no_grad():
        probs = port.mask_probs(nchw(imgs))[:, 0, ::stride, ::stride].numpy()
    far = np.abs(probs - 0.5) > THRESHOLD_MARGIN
    got_bits = np.unpackbits(got.numpy(), axis=-1)[..., :width]
    want_bits = np.unpackbits(want, axis=-1)[..., :width]
    assert far.mean() > 0.99 and 0 < want_bits.mean() < 1
    np.testing.assert_array_equal(got_bits[far], want_bits[far])


def test_sync_stride1_step_equals_in_forward_step(jax_init):
    """One sync bridge step at stride 1 and one in-forward step from the
    same state and batch (f64; the traced points are f32 on both paths):
    the same losses and weights."""
    _, params, stats, consts = jax_init
    port = port_model(params, stats, consts, torch.float64).train()
    twin = copy.deepcopy(port)
    b = batch(4)[0]
    tensors = tuple(t.double() if t.is_floating_point() else t for t in _tensors(b))
    _, m1 = TS.make_bc_train_step(port)(frozen_backbone_adam(port, LR), *tensors)
    state2 = frozen_backbone_adam(twin, LR)
    tracer = TS.BridgeTracer(IMG, 1, MP)
    pts, counts = tracer.submit(TS.make_bc_mask_step(twin, 1)(state2, tensors[0])).result()
    tracer.close()
    _, m2 = TS.make_bc_train_step(twin)(state2, *tensors,
                                          (torch.from_numpy(pts), torch.from_numpy(counts)))
    assert counts.min() > 0
    for k in TS.METRIC_KEYS:
        np.testing.assert_allclose(float(m2[k]), float(m1[k]), rtol=1e-12, err_msg=k)
    for (k, a), (_, b2) in zip(port.state_dict().items(), twin.state_dict().items()):
        torch.testing.assert_close(b2, a, rtol=0, atol=1e-12, msg=k)


def test_sync_bridge_contours_equal_in_forward_trace(jax_init):
    """The bridge's stride-1 contours are the in-forward trace's, point for point."""
    _, params, stats, consts = jax_init
    port = port_model(params, stats, consts).train()
    imgs = nchw(batch(5)[0]["imgs"])
    with torch.no_grad():
        preds = port(imgs)
    tracer = TS.BridgeTracer(IMG, 1, MP)
    state = frozen_backbone_adam(port, LR)
    pts, counts = tracer.submit(TS.make_bc_mask_step(port, 1)(state, imgs)).result()
    tracer.close()
    np.testing.assert_array_equal(pts, preds["contours"].numpy())
    np.testing.assert_array_equal(counts, preds["contour_counts"].numpy())


def _jax_overlap(jax_init, batches, stride):
    """The JAX trainer's overlap loop (cli/train_bc.py:164-205) with its
    mask step, tracer and external-contour step."""
    model = jax_init[0]
    state = _jax_state(jax_init)
    mask_step = JS.make_bc_mask_step(model, stride=stride)
    step = JS.make_bc_train_step(model, max_points=MP, external_contours=True)
    tracer = JS.BridgeTracer(IMG, stride, MP)
    out, pending = [], None

    def trace_and_train(state, b, fut):
        pts, counts = fut.result()
        state, m = step(state, jnp.asarray(b["imgs"]), pts, counts,
                        *(jnp.asarray(b[k]) for k in TS.TARGET_KEYS))
        out.append({k: float(v) for k, v in m.items()})
        return state

    for b in batches:
        fut = tracer.submit(mask_step(state, jnp.asarray(b["imgs"])))
        if pending is not None:
            state = trace_and_train(state, *pending)
        pending = (b, fut)
    trace_and_train(state, *pending)
    return out


def test_overlap_run_matches_jax_overlap_loop(jax_init):
    """3 f32 steps through run_epoch's overlap bridge (stride 4: one-step-
    stale masks, the last batch flushed) against the JAX trainer's loop
    from the converted weights: each step's losses within TRAJ_RTOL."""
    _, params, stats, consts = jax_init
    batches = [batch(30 + i)[0] for i in range(3)]
    want = _jax_overlap(jax_init, batches, 4)
    port = port_model(params, stats, consts).train()
    got = []
    astep = accumulating(TS.make_bc_train_step(port))

    def record(state, acc, cnt, *args):
        state, acc, cnt = astep(state, acc, cnt, *args)
        got.append({k: float(v) for k, v in acc.items()})
        return state, acc, cnt

    tracer = TS.BridgeTracer(IMG, 4, MP)
    _, _, cnt = run_epoch(record, frozen_backbone_adam(port, LR),
                                [_tensors(b) for b in batches],
                                (TS.make_bc_mask_step(port, 4), tracer), overlap=True)
    tracer.close()
    assert cnt == 3
    per_step = [{k: g[k] - (got[i - 1][k] if i else 0.0) for k in g} for i, g in enumerate(got)]
    for p, j in zip(per_step, want):
        for k in TS.METRIC_KEYS:
            np.testing.assert_allclose(p[k], j[k], rtol=TRAJ_RTOL, err_msg=f"{k}: {per_step} vs {want}")


class _ImmediateTracer:
    def __init__(self, log):
        self.log = log

    def submit(self, packed):
        self.log.append(("trace", packed))
        f = Future()
        f.set_result((packed * 10, packed))
        return f


@pytest.mark.parametrize("n", [0, 1, 2, 5])
def test_pipeline_order_matches_jax(n):
    """The same dispatch order and results as the JAX generator's: mask(i+1)
    before refine(i), results in order."""
    from vaeplay_tpu.eval.serve import pipeline_bc_batches as jax_pipeline

    logs, outs = [], []
    for pipe in (pipeline_bc_batches, jax_pipeline):
        log = []

        def dispatch_mask(x):
            log.append(("mask", x))
            return x

        def dispatch_refine(x, pts, counts):
            log.append(("refine", x))
            return ("refined", x, pts, counts)

        outs.append(list(pipe(dispatch_mask, _ImmediateTracer(log).submit, dispatch_refine,
                              list(range(n)))))
        logs.append(log)
    assert logs[0] == logs[1] and outs[0] == outs[1]
    assert outs[0] == [(x, ("refined", x, x * 10, x)) for x in range(n)]


def test_pipeline_serves_bc_as_the_sequential_loop(jax_init):
    """BC served through the pipeline (eval-mode mask program, tracer,
    injected-contour forward) against the sequential loop on 4 batches."""
    _, params, stats, consts = jax_init
    port = port_model(params, stats, consts).eval()
    xs = [nchw(batch(40 + i)[0]["imgs"]) for i in range(4)]
    tracer = TS.BridgeTracer(IMG, 1, MP)

    def refine(x, pts, counts):
        return port(x, contours=(torch.from_numpy(pts), torch.from_numpy(counts)))

    with torch.no_grad():
        got = list(pipeline_bc_batches(port.mask_bits, tracer.submit, refine, xs))
        want = [port(x) for x in xs]
    tracer.close()
    assert [g[0] is x for g, x in zip(got, xs)] == [True] * 4
    for (_, g), w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            torch.testing.assert_close(g[k], w[k], rtol=0, atol=0, msg=k)
