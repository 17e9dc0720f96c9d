"""The port's host spans (vaeplay_torch/utils/profiling.py): the store, the
parents, the profiler's timeline, the span trees of a BP step, a Style_GAN
step and a BP batch, and the benchmark's kernel groups with the program's
span names in the op chain."""

import threading

import numpy as np
import pytest
import torch

from benchmark.core import trace as T
from vaeplay_torch.cli import test_bp, train_bp
from vaeplay_torch.cli.train_style_gan import Bucketing, device_batches
from vaeplay_torch.data.be_data import SyntheticBubbleDataset
from vaeplay_torch.data.bp_data import SyntheticEmitDataset
from vaeplay_torch.models.bp import ComposeNet
from vaeplay_torch.models.style_gan import Discriminator, Generator, StyleEncoder
from vaeplay_torch.train.metrics import accumulating
from vaeplay_torch.train.state import StyleGanState, TrainState
from vaeplay_torch.train.steps_bp import make_bp_train_step
from vaeplay_torch.train.steps_style_gan import make_style_gan_train_step
from vaeplay_torch.utils import profiling as P

SMALL = ((16, 2), (32, 2), (64, 2), (64, 2), (64, 2), (64, 1), (64, 1))  # tests/test_torch_bp.py
CPU = torch.device("cpu")

# (name, parent) of each record, in the order the spans close
BP_STEP = [("data.h2d", None)] * 3 + [
    ("train.forward", "train.step"), ("train.backward", "train.step")] * 2 + [("train.step", None)]
STYLE_GAN_STEP = [("data.h2d", "data.feed"), ("data.h2d", "data.feed"), ("data.feed", None)] + [
    ("train.forward", "train.step"), ("train.backward", "train.step")] * 3 + [("train.step", None)]
BP_BATCH = [("data.h2d", "infer.predict"), ("infer.forward", "infer.predict"),
            ("infer.predict", None)]


@pytest.fixture(autouse=True)
def empty_store():
    P.reset_spans()
    yield
    P.reset_spans()


def tree():
    return [(s.name, s.parent) for s in P.spans()]


def test_a_span_with_the_profiler_off_stores_one_record_and_no_range(monkeypatch):
    entered = []
    monkeypatch.setattr(P, "record_function", lambda name: entered.append(name))
    with P.span("train.step"):
        pass
    (rec,) = P.spans()
    assert entered == [] and rec.name == "train.step" and rec.parent is None
    assert not rec.profiled and 0 <= rec.start_ns <= rec.end_ns


def test_nested_spans_store_their_parents_per_thread():
    def inner():
        with P.span("data.h2d"):
            pass

    with P.span("train.step"):
        with P.span("train.forward"):
            with P.span("data.feed"):
                worker = threading.Thread(target=inner)
                worker.start()
                worker.join(timeout=30)
        with P.span("train.backward"):
            pass
    assert not worker.is_alive()
    assert sorted(tree()) == sorted([
        ("data.h2d", None), ("data.feed", "train.forward"), ("train.forward", "train.step"),
        ("train.backward", "train.step"), ("train.step", None)])
    assert tree()[-1] == ("train.step", None)  # records go in as spans close


def test_spans_lie_on_the_profilers_timeline():
    from torch.profiler import ProfilerActivity, profile

    names = ("train.step", "train.forward", "data.feed")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.span(names[0]):
            with P.span(names[1]):
                with P.span(names[2]):
                    torch.ones(4).sum()
    with P.span("train.backward"):  # the profiler has stopped
        pass
    (op,) = [e for e in prof.events() if e.name == "aten::sum"]
    events = [e for e in prof.events() if e.name in names]
    assert sorted(e.name for e in events) == sorted(names)
    assert {e.thread for e in events} == {op.thread}
    assert {s.name: s.profiled for s in P.spans()} == {**{n: True for n in names},
                                                       "train.backward": False}


def test_the_store_is_a_bounded_ring():
    for i in range(P.SPAN_RING + 10):
        with P.span(f"data.{i}"):
            pass
    recs = P.spans()
    assert len(recs) == P.SPAN_RING and P.spans() == recs  # reading clears nothing
    assert recs[0].name == "data.10" and recs[-1].name == f"data.{P.SPAN_RING + 9}"
    P.reset_spans()
    assert P.spans() == []


def _bp_step():
    torch.manual_seed(0)
    model = ComposeNet(image_size=64, emit_channels=SMALL).train()
    step = accumulating(make_bp_train_step(model))
    state = TrainState.create(model, 1e-3)
    batch = SyntheticEmitDataset(img_size=64, data_size=2, seed=0).sample_batch(2)
    return model, lambda: step(state, None, 0, *train_bp.to_device(batch, CPU))


def test_a_bp_step_stores_its_span_tree():
    _, run = _bp_step()
    P.reset_spans()
    run()
    assert tree() == BP_STEP


def test_a_style_gan_step_stores_its_span_tree():
    torch.manual_seed(0)
    img, z, b = 32, 16, 4
    e, g, d = StyleEncoder(z, img, max_channels=64), Generator(img, z), Discriminator(img)
    ss = StyleGanState.create(e, g, d, 1e-4)
    step = accumulating(make_style_gan_train_step(e, g, d, z))
    dset = SyntheticBubbleDataset(img_size=img, data_size=2 * b, seed=0)
    batches = device_batches(dset, b, 0, 0, 2, Bucketing(True, 2, b), CPU)
    step(ss, None, 0, *next(batches))
    assert tree() == STYLE_GAN_STEP


def test_a_bp_batch_stores_its_span_tree():
    model, _ = _bp_step()
    imgs = np.zeros((2, 64, 64, 3), np.float32)
    P.reset_spans()
    test_bp.predict(model.eval(), imgs, CPU)
    assert tree() == BP_BATCH


# each kind of launch the benchmark groups: (kernel, the ops around its
# launch, innermost first, its group)
LAUNCHES = {
    "attention forward": ("flash_attention_fwd_kernel", ["aten::empty", "SpatialAttention"],
                          T.ATTN_FWD),
    "attention backward": ("void at::native::softmax_backward_kernel",
                           ["aten::_softmax_backward_data",
                            "autograd::engine::evaluate_function: SpatialAttentionBackward"],
                           T.ATTN_BWD),
    "adam": ("void at::native::multi_tensor_apply_kernel",
             ["aten::_foreach_addcdiv_", "Optimizer.step#Adam.step"], T.OPTIMIZER),
    "copy": ("void at::native::elementwise_kernel", ["aten::copy_", "aten::_to_copy", "aten::to"],
             T.COPIES),
    "h2d": ("Memcpy HtoD (Pageable -> Device)", ["aten::copy_", "aten::_to_copy", "aten::to"],
            T.H2D),
    "convolution": ("sm90_xmma_fprop_implicit_gemm",
                    ["aten::cudnn_convolution", "aten::_convolution", "aten::convolution",
                     "aten::conv2d"], T.CONV_FWD),
}
SPANS = ("train.forward", "train.backward", "data.h2d", "data.feed", "infer.forward",
         "infer.predict", "train.step")


@pytest.mark.parametrize("launch", sorted(LAUNCHES))
def test_program_spans_leave_the_kernel_groups_as_they_were(launch):
    kernel, ops, want = LAUNCHES[launch]
    assert T.group(kernel, ops + ["bench.step"]) == want
    for at in range(1, len(ops) + 1):
        for name in SPANS:
            chain = ops[:at] + [name] + ops[at:] + ["train.step", "bench.step"]
            assert T.group(kernel, chain) == want, (name, at)


@pytest.mark.parametrize("kernel,ops,want", [
    ("void at::native::vectorized_elementwise_kernel", ["aten::addcmul"],
     "FrozenBatchNorm (addcmul)"),
    ("void at::native::vectorized_elementwise_kernel",
     ["aten::mul", "autograd::engine::evaluate_function: AddcmulBackward0"],
     "FrozenBatchNorm (addcmul), backward"),
    ("void at::native::upsample_bilinear2d_out_frame", ["aten::upsample_bilinear2d"],
     "upsampling (bilinear, nearest)"),
    ("void at::native::upsample_nearest2d_backward_out_frame",
     ["aten::upsample_nearest2d_backward",
      "autograd::engine::evaluate_function: UpsampleNearest2DBackward0"],
     "upsampling (bilinear, nearest), backward"),
    ("void at::native::vectorized_elementwise_kernel", ["aten::add_"], "elementwise and other"),
    ("flash_attention_fwd_kernel", ["aten::addcmul", "SpatialAttention"], T.ATTN_FWD),
])
def test_chip_smokes_breakdown_names_the_vae_gans_groups(kernel, ops, want):
    """chip_smoke's per-kernel breakdown takes the benchmark's groups and
    names FrozenBatchNorm's and the upsampling's elementwise kernels apart."""
    import chip_smoke

    assert chip_smoke._vae_gan_group(T.group(kernel, ops), ops) == want
