"""The yardstick's arithmetic: busy time as a union of intervals, the
attribution of kernels to layers, the one-pass attention bound and the FLOP
count, each against a hand count."""

import pytest
import torch

from benchmark.core import trace as T
from benchmark.core.peaks import attention_bound_s
from benchmark.core.readers import attention_roofline_pct, idle_pct, mfu_pct
from benchmark.core.record import RunRecord
from benchmark.reference.common import Ops, flop_counter


def test_busy_time_is_the_union_of_overlapping_activities():
    kernels = [(0.0, 10.0), (5.0, 15.0), (12.0, 14.0), (20.0, 30.0), (35.0, 50.0)]
    assert T.busy(kernels, 0.0, 40.0) == 30.0  # a sum would give 37
    assert T.gaps(kernels, 0.0, 40.0) == [(15.0, 20.0), (30.0, 35.0)]
    trace = T.Trace(window_s=40.0, busy_s=T.busy(kernels, 0.0, 40.0), groups={}, idle_gaps=[])
    record = RunRecord(kind="train", compute_dtype="float32", samples_per_step=1, setup_s=1.0,
                       window_s=1.0, window_steps=1, trace=trace, traced_steps=1)
    assert idle_pct(record) == pytest.approx(25.0)


@pytest.mark.parametrize("kernel, ops, transposed, group", [
    ("void flash_attention_bf16_kernel<false>(Params)", ["SpatialAttention"], False, T.ATTN_FWD),
    ("ampere_sgemm_128x64_nn", ["aten::bmm", "autograd::engine::evaluate_function: "
                                "SpatialAttentionBackward"], False, T.ATTN_BWD),
    ("multi_tensor_apply_kernel", ["aten::_foreach_add_", "Optimizer.step#Adam.step"], False,
     T.OPTIMIZER),
    ("nchwToNhwcKernel", ["aten::cudnn_convolution", "aten::conv2d"], False, T.LAYOUT),
    ("sm90_xmma_fprop_implicit_gemm", ["aten::cudnn_convolution", "aten::conv2d"], False,
     T.CONV_FWD),
    ("unrolled_elementwise_kernel", ["aten::copy_", "aten::_to_copy", "aten::conv2d"], False,
     T.COPIES),
    ("sm90_xmma_dgrad", ["aten::convolution_backward", "autograd::engine::evaluate_function: "
                         "ConvolutionBackward0"], False, T.CONV_BWD),
    ("sm90_xmma_wgrad", ["aten::convolution_backward", "autograd::engine::evaluate_function: "
                         "ConvolutionBackward0"], True, T.CONVT_BWD),
    ("Memcpy HtoD (Pageable -> Device)", ["aten::copy_", "aten::to"], False, T.H2D),
    # a hand-written attention backward, under its autograd node or not, is never forward time
    ("void flash_attention_bwd_kernel<true>(Params)", ["autograd::engine::evaluate_function: "
                                                       "SpatialAttentionBackward"], False,
     T.ATTN_BWD),
    ("void flash_attention_fwd_kernel<true>(Params)", ["autograd::engine::evaluate_function: "
                                                       "SpatialAttentionBackward"], False,
     T.ATTN_BWD),
    ("void flash_attention_bwd_kernel<true>(Params)", ["aten::empty"], False,
     "elementwise and other"),
])
def test_kernels_are_attributed_to_their_layer(kernel, ops, transposed, group):
    assert T.group(kernel, ops, transposed) == group


def test_a_cpu_profile_reduces_to_an_idle_window():
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.window"):
            with record_function("bench.step"):
                torch.randn(64, 64) @ torch.randn(64, 64)
    tr = T.reduce_profile(prof, "bench.window")
    assert tr.window_s > 0 and tr.busy_s == 0 and tr.idle_gaps[0][1] == pytest.approx(tr.window_s)


def test_the_attention_bound_is_one_pass_at_the_operand_peak():
    # BP's training shape in bf16: 2 B N² (Dk + Dv) operations at 989 TFLOP/s
    flops = 2 * 8 * 2048 ** 2 * (90 + 720)
    assert flops == 54_358_179_840
    assert attention_bound_s((8, 2048, 90, 720), "bfloat16") == pytest.approx(flops / 989e12)
    # BP's inference shape in f32: once at TF32's 495 TFLOP/s, not three passes
    assert attention_bound_s((4, 2048, 90, 720), "float32") == pytest.approx(flops / 2 / 495e12)
    # a shape bound by its bytes: q, k, v read and the output written once at 3.35 TB/s
    b, n, dk, dv = 32, 1, 32, 256
    assert attention_bound_s((b, n, dk, dv), "float32") == pytest.approx(
        4 * (2 * b * n * dk + 2 * b * n * dv) / 3.35e12)


def test_the_reference_flop_count_matches_a_hand_count():
    ops = Ops("f32")
    x = torch.randn(2, 3, 8, 8, requires_grad=True)
    w = torch.randn(4, 3, 3, 3, requires_grad=True)
    lw = torch.randn(5, 4 * 64, requires_grad=True)
    q, k, v = torch.randn(2, 16, 4), torch.randn(2, 16, 4), torch.randn(2, 16, 6)
    with flop_counter() as fc:
        h = ops.conv2d(x, w, None, 1, 1)
        y = ops.linear(h.flatten(1), lw, None)
        y.sum().backward()
        ops.attention(q, k, v)
    conv = 2 * 2 * 4 * 64 * 3 * 9   # N Cout H W Cin k², multiply and add
    linear = 2 * 2 * 256 * 5
    attention = 2 * 2 * 16 * 16 * 4 + 2 * 2 * 16 * 16 * 6
    # backward: the linear's input and weight gradients, the conv's input and weight gradients
    assert fc.get_total_flops() == 3 * conv + 3 * linear + attention
    assert ops.attention_shapes == [(2, 16, 4, 6)]


def test_mfu_and_roofline_read_the_traced_window():
    trace = T.Trace(window_s=2.0, busy_s=1.5, groups={T.ATTN_FWD: 0.5}, idle_gaps=[])
    r = RunRecord(kind="train", compute_dtype="bfloat16", samples_per_step=8, setup_s=1.0,
                  window_s=1.0, window_steps=1, trace=trace, traced_steps=4,
                  flops_per_step=989e12 * 0.05, attention_bound_s=0.025)
    assert mfu_pct(r) == pytest.approx(10.0)  # 4 steps of 0.05 s at peak in 2 s
    assert attention_roofline_pct(r) == pytest.approx(20.0)  # 4 x 0.025 s over 0.5 s


def test_the_nudged_witness_starts_one_ulp_up():
    from benchmark.reference.common import nudged

    w = {"a": torch.tensor([0.0, 1.0, -2.5, 3e-20]), "b": torch.full((2, 2), 0.125)}
    up = nudged(w)
    for k, v in w.items():
        assert torch.all(up[k] > v)
        assert torch.equal(torch.nextafter(up[k], torch.full_like(v, -float("inf"))), v)
