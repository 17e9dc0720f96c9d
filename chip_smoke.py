"""Smoke run of the PyTorch/CUDA port (vaeplay_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; each raises on failure and nothing is caught:

1. build   -- compile every CUDA source of the port with nvcc.
2. kernels -- hold each kernel against its plain PyTorch version on the card
              (TF32 off), at the shapes of the BP path, at ragged shapes and
              at Dk = 128, with q, k, v position-major (contiguous (B, N, C))
              and channel-major (transpose views of (B, C, N), the layout
              the model passes, with a channel-major result; the kernel
              reads it with no copy), and time kernel, plain version and
              the PyTorch library call. Then the attention under autograd:
              the gradients of `SpatialAttention` (the kernel's forward, the
              recompute backward) against autograd through the plain
              version; at the training batch of 8, the forward and the
              gradients against the plain version, then their times.
3. slice   -- BP inference through the port's test_bp CLI at 512 px, batch 4,
              the full emit-channel pyramid, seeded random weights with every
              attention gamma nonzero: one CLI run that must write a PNG,
              then a warm-up and three timed synthetic batches, at PyTorch's
              default precision and again in strict f32, and a profile of a
              few more forwards. Every forward must launch the attention
              kernel exactly 9 times.
4. parity  -- the same weights and image at batch 1: the card's forward
              (kernels) against the port's CPU forward (plain versions).
5. train   -- BP training through the port's train_bp CLI at 512 px, batch
              8, the full pyramid, synthetic data: one epoch of 4
              iterations, a resume of that run for a second epoch, and
              test_bp rendering the resumed run dir. Every iteration must
              launch the attention kernel exactly 18 times (9 per pass) and
              every logged loss be finite. Then a warm-up and three timed
              iterations at PyTorch's defaults, the peak device memory, and
              a profile of one iteration by kernel group.
6. train parity -- one two-pass iteration on the card and on the CPU from
              the same weights and batch (128 px, batch 2, a narrow
              pyramid, TF32 off): the seven losses and pass 1's gradients.
7. vae-train -- the circle VAE-GAN through the port's train_vae CLI at the
              JAX package's benchmark shape (bench.py: 256 px, batch 128,
              z 128, circles rendered on the card): bf16 for an epoch of 4
              steps, a resume of it for a second, f32 for an epoch of 2;
              every logged loss finite, a grid per epoch, a checkpoint per
              epoch. Then the step's FLOPs from the layer shapes and its
              bound at the bf16 and TF32 tensor rates, a warm-up and three
              timed steps in f32 and in bf16 at PyTorch's defaults with the
              peak device memory, and a profile of a bf16 step by kernel
              group. The attention kernel is on no path here, and its launch
              count must not move.
8. vae parity -- one f32 VAE-GAN step on the card and on the CPU from the
              same weights, circle batch and injected noise (64 px, batch
              4, z 32, TF32 off): the five losses, every gradient and the
              BatchNorm running buffers.
9. be-infer -- BE (ResNet50-FPN bubble mask and edge segmentation) inference
              through the port's test_be CLI at 512 px, batch 8, full width,
              seeded random weights with random FrozenBatchNorm constants:
              one CLI run that must write its two grids, then a warm-up and
              three timed batches (host clock around the copy, forward,
              sigmoid and synchronize), the peak device memory, the forward's
              FLOPs and bound, and a profile by kernel group.
10. be-train -- BE training through the port's train_be CLI at 512 px, batch
              32, full width, bubbles rendered and augmented on the card:
              bf16 for an epoch of 3 iterations, a resume of it for a second,
              f32 for an epoch of 2, and test_be on the resumed run dir.
              Then the step's FLOPs and bound, a warm-up and three timed
              steps in f32 and in bf16 with the peak device memory, and a
              profile of a step in each by kernel group.
11. be parity -- one BE training step at 128 px, batch 2, the full-width
              backbone, on the card and on the CPU from the same weights and
              noise images (TF32 off): in f32 both losses and every BatchNorm
              buffer, in f64 the losses, every gradient and every buffer.
The attention kernel is on no path of phases 7-11: its launch count must
not move there.

It prints the card's name and power limit, one JSON line describing the
kernels, and as its last line {"ok": true, "device": {...}}. It exits
non-zero without a result when no CUDA device is present.

    python3 chip_smoke.py --profile-only

builds the kernels and runs only phase 3's profile (the device time of a BP
forward by kernel group); run from another checkout of the repo, it profiles
that checkout's package, so two versions compare with one script.
"""

import contextlib
import copy
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA's data-sheet peaks for one H100 SXM (dense): f32 outside the tensor
# cores, TF32 on the tensor cores, and HBM3 bandwidth. They assume the card's
# full 700 W power limit.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
# The attention kernel's engine, its one path: TF32 tensor cores in three
# passes (big*big + big*small + small*big), wgmma for P.V and mma.sync for the
# scores, K and V loaded by the TMA engine.
ENGINE = "wgmma m64n120k8 + mma.sync m16n8k8, tf32x3"
TF32_PASSES = 3

# (B, N, Dk, Dv) of the BP attention (models/bp.py: 2048 embedding dims as
# positions, 720 points as channels, q/k reduced 8x) and the ragged shapes.
BP_SHAPE = (4, 2048, 90, 720)
RAGGED = [(2, 64, 4, 32), (2, 100, 8, 16), (2, 256, 16, 128), (2, 333, 5, 7),
          (2, 2049, 90, 720), (2, 2049, 5, 7)]
DK_MAX = [(2, 300, 128, 200), (1, 2048, 128, 720)]  # the kernel's largest Dk
# f32: the kernel and the plain version both compute in f32 and differ only in
# summation order. bf16: both widen the inputs to f32 and round only the
# output, so they differ by up to one bf16 rounding (2^-8 relative) plus
# summation order.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
# the Function's gradients against autograd of the plain version, both f32 on
# the card: 1e-4 of each gradient's largest magnitude (ds = (dp - sum(dp *
# attn)) * attn cancels, so an element's error follows its gradient's scale)
# plus 1e-4 relative; the forward inside is the kernel's, within TOL
GRAD_TOL = (1e-4, 1e-4)
PARITY_TOL = (1e-3, 1e-3)  # card forward vs CPU forward, see phase_parity
PER_FORWARD = 9  # attention launches: 3 ValueEncoder + 3 tower-a + 3 tower-b blocks
PER_ITERATION = 2 * PER_FORWARD  # a training iteration: the full model, then stage 2
IMG = 512  # the reference's image size (train_BP.py:131-145, test_BP.py)
TRAIN_BATCH, TRAIN_ITERATIONS = 8, 4  # the reference trainer's batch (train_BP.py:131-145)
# phase 6 on the CPU as well: 128 px, batch 2, the tests' narrow pyramid
TRAIN_PARITY = dict(img=128, batch=2,
                    channels=((16, 2), (32, 2), (64, 2), (64, 2), (64, 2), (64, 1), (64, 1)))
# losses and pass 1's gradients, card vs CPU: 1e-3 of each gradient's largest
# magnitude (or of each loss) plus 1e-3 relative, see phase_train_parity
TRAIN_PARITY_TOL = (1e-3, 1e-3)
# the circle VAE-GAN at the JAX package's benchmark shape (bench.py:35-45):
# VaeGan(img_size=256, z_size=128), batch 128; the CLI runs an epoch of
# VAE_ITERATIONS[dtype] steps, then VAE_TIMED steps are timed after a warm-up
VAE_IMG, VAE_BATCH, VAE_Z = 256, 128, 128
VAE_ITERATIONS = {"bfloat16": 4, "float32": 2}
VAE_TIMED = 3
PEAK_BF16_FLOPS = 989e12  # dense, NVIDIA's data sheet, at 700 W
# phase 8 on the CPU as well: 64 px, batch 4, z 32; losses, gradients and BN
# buffers within 1e-3 of each tensor's largest magnitude plus 1e-3 relative
VAE_PARITY = dict(img=64, batch=4, z=32)
VAE_PARITY_TOL = (1e-3, 1e-3)
# BE at the JAX CLIs' defaults: test_be batch 8, train_be batch 32, 512 px,
# ResNet50 (3, 4, 6, 3) x 64, FPN 256; the CLI runs an epoch of
# BE_ITERATIONS[dtype] iterations, then BE_TIMED steps are timed after a warm-up
BE_IMG, BE_INFER_BATCH, BE_TRAIN_BATCH = 512, 8, 32
BE_ITERATIONS = {"bfloat16": 3, "float32": 2}
BE_TIMED = 3
# phase 11 on the CPU as well: 128 px, batch 2, the full-width backbone; in
# f32 the losses and BN buffers within 1e-3 of each tensor's largest
# magnitude plus 1e-3 relative, in f64 the losses, gradients and BN buffers
# within 1e-9 (see phase_be_parity)
BE_PARITY = dict(img=128, batch=2)
BE_PARITY_TOL = {torch.float32: (1e-3, 1e-3), torch.float64: (1e-9, 1e-9)}
# fpn.layer_blocks.0's output meets aux_convs.0, a 1x1 convolution and then a
# train-mode BatchNorm, which takes out any per-channel constant: its bias's
# true gradient is 0 and both sides hold rounding, so it is held to the bound
# of its layer's weight gradient
BE_ZERO_GRADS = {"grad feature_net.backbone.fpn.layer_blocks.0.bias":
                 "grad feature_net.backbone.fpn.layer_blocks.0.weight"}


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over iters launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def strict_f32():
    """f32 matmuls and convolutions in full f32 (no TF32) inside the block;
    PyTorch's defaults (TF32 convolutions, f32 matmuls) are restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def phase_build() -> None:
    from vaeplay_torch.ops import _build

    t0 = time.perf_counter()
    report = _build.build()
    print(f"[build] {len(report)} libraries in {time.perf_counter() - t0:.1f} s")
    for name, r in report.items():
        print(f"[build] {name}: {r['seconds']:.1f} s")
        for line in r["log"].splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "error")):
                print(f"[build]   {line.strip()}")


def _qkv(shape, dtype, seed, q_scale=1.0, layout="nc"):
    """Seeded q, k, v of shape (B, N, C). layout is one letter per tensor:
    'n' position-major (contiguous (B, N, C)), 'c' channel-major (the
    transpose view of a contiguous (B, C, N)); one letter stands for all three."""
    b, n, dk, dv = shape
    layout = layout * 3 if len(layout) == 1 else layout
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k = (torch.randn(b, n, dk, generator=g, device="cuda") for _ in range(2))
    v = torch.randn(b, n, dv, generator=g, device="cuda")
    out = []
    for t, form in zip(((q * q_scale), k, v), layout):
        t = t.to(dtype)
        out.append(t if form == "n" else t.transpose(1, 2).contiguous().transpose(1, 2))
    return tuple(out)


def _check_case(shape, dtype, layout, q_scale, seed) -> float:
    """The kernel against the plain version on one case; returns the max abs
    error. Channel-major inputs go through spatial_self_attention, whose
    result must be channel-major too."""
    from vaeplay_torch.ops import attention

    q, k, v = _qkv(shape, dtype, seed, q_scale, layout)
    if shape == BP_SHAPE and dtype == torch.float32 and layout == "c" and not (
            attention._tma_operand(k) is k and attention._tma_operand(v) is v):
        raise AssertionError("the model's layout at the BP shape was copied for the kernel")
    if layout == "c":
        got = attention.spatial_self_attention(q, k, v)
        if not got.transpose(1, 2).is_contiguous():
            raise AssertionError(f"channel-major inputs gave strides {got.stride()}")
    else:
        got = attention.flash_attention(q, k, v)
    torch.cuda.synchronize()
    ref = attention.reference_attention(q, k, v)
    atol, rtol = TOL[dtype]
    err = (got.float() - ref.float()).abs()
    bad = int((err > atol + rtol * ref.float().abs()).sum())
    max_err = float(err.max())
    rel = max_err / max(float(ref.float().abs().max()), 1e-30)
    print(f"[kernels] flash_attention_fwd B,N,Dk,Dv={shape} {str(dtype)[6:]} layout {layout}: "
          f"max abs err {max_err:.3e}, max rel err {rel:.3e} "
          f"(atol {atol:g}, rtol {rtol:g}), {bad} outside")
    if got.shape != ref.shape or bad or not torch.isfinite(got).all():
        raise AssertionError(f"flash_attention_fwd disagrees with the plain version at "
                             f"{shape} {dtype} layout {layout}")
    return max_err


def phase_kernels(gpu: str) -> dict:
    from vaeplay_torch.ops import attention

    # BP's shape with unit-variance inputs (a peaked softmax), the ragged
    # shapes with q scaled down: a flat softmax, where a padded key column
    # that escaped the mask would carry as much weight as a real one. Layout
    # 'n' is position-major, 'c' channel-major (the model's), 'ncn' and 'cnc'
    # mix the two (q, k, v in turn).
    cases = [(BP_SHAPE, torch.float32, 1.0, "n"), (BP_SHAPE, torch.bfloat16, 1.0, "n")]
    cases += [(s, torch.float32, 0.05, "n") for s in RAGGED]
    cases += [(BP_SHAPE, torch.float32, 1.0, "c"), (BP_SHAPE, torch.bfloat16, 1.0, "c")]
    cases += [(s, torch.float32, 0.05, "c") for s in RAGGED]
    cases += [(s, torch.bfloat16, 0.05, "c") for s in RAGGED[3:]]
    cases += [(s, torch.float32, 0.05, lay) for s in DK_MAX for lay in ("n", "c")]
    cases += [(RAGGED[3], torch.float32, 0.05, "ncn"), (RAGGED[4], torch.float32, 0.05, "cnc")]
    bp_err = None
    for i, (shape, dtype, q_scale, layout) in enumerate(cases):
        err = _check_case(shape, dtype, layout, q_scale, seed=i)
        if shape == BP_SHAPE and dtype == torch.float32 and layout == "c":
            bp_err = err

    # timed at the BP shape in f32, channel-major as the model passes them
    # (kernel, plain version and library call on the same views), and
    # position-major for comparison (there flash_attention copies k and v
    # into the kernel's layout first)
    ms, plain_ms, library_ms = _forward_times(BP_SHAPE, "c")
    bound_ms, bound_by, flops = _forward_bound(BP_SHAPE)
    print(f"[kernels] BP shape f32, channel-major, on {gpu}: kernel_ms {ms:.4f}, "
          f"plain_ms {plain_ms:.4f}, library_ms {library_ms:.4f}, bound_ms {bound_ms:.4f} "
          f"({TF32_PASSES} x {flops / 1e9:.2f} GFLOP at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s "
          f"TF32), bound_f32_cuda_core_ms {flops / PEAK_F32_FLOPS * 1e3:.4f}; "
          f"kernel at {flops / ms / 1e9:.1f} TFLOP/s counted once, "
          f"{bound_ms / ms:.1%} of its bound")
    times_n = _forward_times(BP_SHAPE, "n")
    print(f"[kernels] BP shape f32, position-major, on {gpu}: flash_attention_ms "
          f"(copies of k and v, then the kernel) {times_n[0]:.4f}, "
          f"plain_ms {times_n[1]:.4f}, library_ms {times_n[2]:.4f}")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "vaeplay_torch/ops/csrc/flash_attention.cu",
            "replaces": "vaeplay_tpu/ops/attention.py:37", "engine": ENGINE,
            "launches": None, "max_abs_err": bp_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def _forward_times(shape, layout: str):
    """CUDA-event ms of the kernel, the plain version and the library call
    (scaled_dot_product_attention) on the same f32 q, k, v in `layout`."""
    from vaeplay_torch.ops import attention

    b, n, _, dv = shape
    q, k, v = _qkv(shape, torch.float32, seed=0, layout=layout)
    out = (torch.empty(b, dv, n, device="cuda").transpose(1, 2) if layout == "c"
           else torch.empty(b, n, dv, device="cuda"))
    q4, k4, v4 = q[:, None], k[:, None], v[:, None]
    return (cuda_ms(lambda: attention.flash_attention(q, k, v, out=out)),
            cuda_ms(lambda: attention.reference_attention(q, k, v)),
            cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, scale=1.0)))


def _forward_bound(shape):
    """(bound_ms, bound_by, flops) of the attention forward: the larger of
    its products at the TF32 rate, three passes each, and its f32 bytes
    (q, k, v read once, the output written once) at the memory rate."""
    b, n, dk, dv = shape
    flops = 2.0 * b * n * n * (dk + dv)
    t_ops = TF32_PASSES * flops / PEAK_TF32_FLOPS * 1e3
    t_bytes = 4.0 * (2 * b * n * dk + 2 * b * n * dv) / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", flops


def _worst(got: torch.Tensor, ref: torch.Tensor, tol, scale: float = None) -> float:
    """Largest |got - ref| over atol x max |ref| (or x scale) + rtol x |ref|;
    above 1 fails."""
    atol, rtol = tol
    bound = atol * (float(ref.abs().max()) if scale is None else scale) + rtol * ref.abs()
    return float(((got - ref).abs() / bound.clamp(min=1e-30)).max())


def _grad_check(shape, layout, q_scale, seed) -> None:
    """spatial_self_attention's gradients (kernel forward, recompute
    backward) against autograd through the plain version on the same inputs
    and output gradient."""
    from vaeplay_torch.ops import attention

    q, k, v = _qkv(shape, torch.float32, seed, q_scale, layout)
    g = _qkv(shape, torch.float32, seed + 1000, 1.0, layout)[2]
    before = attention.flash_attention.launches
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    attention.spatial_self_attention(qg, kg, vg).backward(g)
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    attention.reference_attention(qr, kr, vr).backward(g)
    torch.cuda.synchronize()
    if attention.flash_attention.launches != before + 1:
        raise AssertionError("the Function's forward did not launch the kernel once")
    worst = max(_worst(got, ref, GRAD_TOL) for got, ref in (
        (qg.grad, qr.grad), (kg.grad, kr.grad), (vg.grad, vr.grad)))
    finite = all(bool(torch.isfinite(t.grad).all()) for t in (qg, kg, vg))
    print(f"[kernels] backward B,N,Dk,Dv={shape} layout {layout}: dq, dk, dv at {worst:.3f} of "
          f"the bound (atol {GRAD_TOL[0]:g} x max |ref| + rtol {GRAD_TOL[1]:g} x |ref|)")
    if worst > 1 or not finite:
        raise AssertionError(f"the Function's gradients disagree with autograd of the plain "
                             f"version at {shape} layout {layout}")


def phase_kernel_backward(gpu: str) -> None:
    """Phase 2's autograd half: the Function's gradients at the BP shape and
    the ragged shapes in both layouts; then, at the shape the training path
    gives the kernel (B = 8, channel-major), the forward and the gradients
    against the plain version on the inputs that are timed after."""
    from vaeplay_torch.ops import attention

    for i, shape in enumerate([BP_SHAPE] + RAGGED):
        for layout in ("c", "n"):
            _grad_check(shape, layout, 1.0 if shape == BP_SHAPE else 0.05, seed=100 + i)

    shape = (TRAIN_BATCH,) + BP_SHAPE[1:]
    _check_case(shape, torch.float32, "c", 1.0, seed=0)  # _forward_times' q, k, v
    _grad_check(shape, "c", 1.0, seed=0)
    b, n, dk, dv = shape
    fwd_ms, plain_ms, library_ms = _forward_times(shape, "c")
    bound_ms, _, flops = _forward_bound(shape)
    print(f"[kernels] forward at B={b} (the training batch), f32, channel-major, on {gpu}: "
          f"kernel_ms {fwd_ms:.4f}, plain_ms {plain_ms:.4f}, library_ms {library_ms:.4f}, "
          f"bound_ms {bound_ms:.4f} ({TF32_PASSES} x {flops / 1e9:.2f} GFLOP at "
          f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s TF32), {bound_ms / fwd_ms:.1%} of its bound")

    q, k, v = _qkv(shape, torch.float32, seed=0, layout="c")
    g = _qkv(shape, torch.float32, seed=1000, layout="c")[2]  # _grad_check's g
    bwd_ms = cuda_ms(lambda: attention.attention_backward(q, k, v, g), iters=10)
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    ref_out = attention.reference_attention(qr, kr, vr)
    autograd_ms = cuda_ms(lambda: torch.autograd.grad(ref_out, (qr, kr, vr), g,
                                                      retain_graph=True), iters=10)
    bwd_flops = 2.0 * b * n * n * (3 * dk + 2 * dv)
    print(f"[kernels] backward at B={b}, f32 (no TF32), channel-major, on {gpu}: "
          f"attention_backward_ms {bwd_ms:.4f} (recompute: 5 bmm + softmax), plain autograd "
          f"backward_ms {autograd_ms:.4f} (saved softmax: 4 bmm); {bwd_flops / 1e9:.2f} GFLOP, "
          f"{bwd_flops / PEAK_F32_FLOPS * 1e3:.4f} ms at {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s f32; "
          f"backward / forward kernel {bwd_ms / fwd_ms:.2f}; per training iteration "
          f"({PER_ITERATION} of each) {PER_ITERATION * fwd_ms:.2f} ms forward, "
          f"{PER_ITERATION * bwd_ms:.2f} ms backward")


def random_model(seed: int = 0, image_size: int = IMG, emit_channels=None):
    """A seeded random ComposeNet (the full emit-channel pyramid unless
    emit_channels is given) with every attention gamma drawn from
    +-[0.2, 0.6] (it starts at 0, which would hide the attention output)."""
    from vaeplay_torch.models.bp import ComposeNet

    model = ComposeNet(image_size=image_size, emit_channels=emit_channels,
                       generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".gamma"):
                sign = 1.0 if torch.rand(1, generator=g).item() < 0.5 else -1.0
                p.copy_(sign * (0.2 + 0.4 * torch.rand(1, generator=g)))
    return model


def random_weights(path: str, seed: int = 0) -> None:
    """random_model's weights at 512 px, saved as test_bp's --model_path reads
    them."""
    torch.save(random_model(seed).state_dict(), path)


def _check_outputs(preds, batch: int) -> None:
    shapes = {"ellipse_params": (batch, 5), "if_triggers": (batch, 720, 2),
              "line_params": (batch, 720, 4), "sample_infos": (batch, 720, 6)}
    for name, shape in shapes.items():
        t = preds[name]
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: shape {tuple(t.shape)} (want {shape}) or not finite")


def _time_batches(model, batches, dev, precision: str, gpu: str) -> None:
    """A warm-up forward, then one timed forward per remaining batch, each
    checked and each launching the attention kernel exactly 9 times."""
    from vaeplay_torch.cli import test_bp
    from vaeplay_torch.ops import attention

    _check_outputs(test_bp.predict(model, batches[0], dev), 4)
    torch.cuda.synchronize()
    for i, imgs in enumerate(batches[1:], 1):
        before = attention.flash_attention.launches
        t = time.perf_counter()
        preds = test_bp.predict(model, imgs, dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        _check_outputs(preds, 4)
        if attention.flash_attention.launches - before != PER_FORWARD:
            raise AssertionError(f"a forward did not launch the kernel {PER_FORWARD} times")
        print(f"[slice] batch {i}: {ms:.2f} ms ({precision}; batch 4, 512 px, host clock "
              f"incl. host-to-device copy) on {gpu}")


def _group(kernel: str, ops, transposed: bool = False) -> str:
    """The profile group of a device activity, from its name and the names of
    the op that launched it and that op's callers (innermost first);
    `transposed`: it runs in the backward of a transposed convolution."""
    node = next((o.rsplit(": ", 1)[-1] for o in ops
                 if o.startswith("autograd::engine::evaluate_function")), "")
    optimizer = next((o for o in ops if o.startswith("Optimizer.")), "")
    if "flash_attention" in kernel:
        return "attention kernel (forward)"
    if "Memcpy" in kernel:
        return "host-to-device copy"
    if optimizer:  # Optimizer.step#Adam.step -> Adam
        return f"{optimizer.split('#')[-1].split('.')[0]} (step and zero_grad)"
    if node.startswith("SpatialAttentionBackward"):
        return "attention backward (bmm, softmax; plain)"
    if any(t in kernel for t in ("nchwToNhwc", "nhwcToNchw")):
        return "cuDNN NCHW<->NHWC transposes"
    if node.startswith("AddcmulBackward") or "aten::addcmul" in ops:
        return "FrozenBatchNorm (addcmul)" + (", backward" if node else "")
    if node.startswith("Upsample") or any(o.startswith("aten::upsample") for o in ops):
        return "upsampling (bilinear, nearest)" + (", backward" if node else "")
    if node.startswith(("CudnnBatchNormBackward", "NativeBatchNormBackward")):
        return "BatchNorm, backward"
    if "aten::batch_norm" in ops:
        return "BatchNorm, forward"
    if node.startswith("ConvolutionBackward"):
        return ("conv-transpose dgrad/wgrad (cuDNN)" if transposed
                else "convolution dgrad/wgrad (cuDNN)")
    if "aten::conv_transpose2d" in ops:
        return "conv-transpose forward (cuDNN)"
    if any(t in kernel for t in ("conv", "fprop", "Nhwc", "Nchw")):
        return "convolution forward (cuDNN)"
    if "gemm" in kernel:
        return "GEMMs (linear layers, 1x1 convolutions)" + (", backward" if node else "")
    if "copy" in kernel:
        return "tensor copies (.contiguous, layout)"
    return "elementwise and other" + (", backward" if node else "")


def _profile(run, label: str, runs: int = 3) -> None:
    """Device time by kernel group per call of run(), over `runs` calls
    (after one profiled call, which pays CUPTI's start-up), against their
    wall time. Each kernel is grouped by its name and by the ops that
    launched it (an autograd node, the optimizer); a backward node is tied
    to its forward op by the autograd sequence number both carry."""
    from torch.profiler import ProfilerActivity, profile

    for n in (1, runs):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(n):
                run()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3 / n
    events = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in events) / 1e3 / runs
    print(f"[{label}] profiled (PyTorch defaults): {busy:.2f} ms device busy, "
          f"{wall:.2f} ms wall, idle share {max(0.0, 1 - busy / wall):.3f}, "
          f"{sum(e.count for e in events) // runs} device activities")
    transposed_seq = {e.sequence_nr for e in prof.events()
                      if e.name == "aten::conv_transpose2d" and e.sequence_nr >= 0}
    groups = {}
    for e in prof.events():
        if e.device_type.name != "CPU" or not e.kernels:
            continue
        ops, parent, transposed = [], e, False
        while parent is not None:
            ops.append(parent.name)
            if parent.name.startswith("autograd::engine::evaluate_function"):
                transposed = parent.sequence_nr in transposed_seq
            parent = parent.cpu_parent
        for k in e.kernels:
            if k.name != e.name:  # a user range's own span on the device
                group = _group(k.name, ops, transposed)
                groups[group] = groups.get(group, 0.0) + k.duration / 1e3 / runs
    attributed = sum(groups.values())
    groups["(not attributed to a launching op)"] = busy - attributed
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[{label}]   {ms:8.3f} ms  {group}")
    for e in events[:12]:
        print(f"[{label}]   {e.self_device_time_total / 1e3 / runs:8.3f} ms  "
              f"x{e.count // runs:<3d} {e.key[:90]}")


def phase_slice(tmp: str, weights: str, gpu: str) -> int:
    """The main path: BP inference through the CLI on cuda:0. Returns the
    attention kernel's launches over the whole phase."""
    from vaeplay_torch.cli import test_bp
    from vaeplay_torch.data.bp_data import SyntheticEmitDataset
    from vaeplay_torch.ops import attention

    dev = torch.device("cuda", 0)
    attention.flash_attention.launches = 0
    t0 = time.perf_counter()
    written = test_bp.main(["--model_path", weights, "--gpu", "0", "--img_size", "512",
                            "--batchsize", "4", "--res_output", os.path.join(tmp, "bp_test")])
    print(f"[slice] CLI run (load, one batch of 4 at 512 px, render) "
          f"{time.perf_counter() - t0:.2f} s; wrote {written}")
    if attention.flash_attention.launches != PER_FORWARD:
        raise AssertionError(f"CLI forward launched the kernel "
                             f"{attention.flash_attention.launches} times, not {PER_FORWARD}")
    if not written or not all(p.endswith(".png") and os.path.getsize(p) > 0 for p in written):
        raise AssertionError(f"CLI wrote no PNG: {written}")

    model = test_bp.load_model(weights, 512, dev)
    ds = SyntheticEmitDataset(img_size=512, data_size=16)
    batches = [ds.sample_batch(4, batch_seed=s)[0] for s in range(4)]
    _time_batches(model, batches, dev, "PyTorch defaults: TF32 convolutions", gpu)
    with strict_f32():
        _time_batches(model, batches, dev, "strict f32, no TF32", gpu)
    _profile(lambda: test_bp.predict(model, batches[1], dev), "slice")
    return attention.flash_attention.launches


def phase_parity(weights: str) -> None:
    """The card's forward (kernels, TF32 off) against the port's CPU forward
    (plain versions) on one image. Both run f32; they differ in conv and
    reduction order, which the softmax and the two stages can amplify, hence
    PARITY_TOL rather than the kernel's own 1e-4."""
    from vaeplay_torch.cli import test_bp
    from vaeplay_torch.data.bp_data import SyntheticEmitDataset

    cpu, dev = torch.device("cpu"), torch.device("cuda", 0)
    ds = SyntheticEmitDataset(img_size=512)
    cpu_model = test_bp.load_model(weights, 512, cpu)
    for seed in range(100, 120):
        img = ds.sample_batch(1, batch_seed=seed)[0]
        ref = test_bp.predict(cpu_model, img, cpu)
        step = float(ref["ellipse_params"][0, 4])
        if abs(step % 1.0 - 0.5) > 0.01:  # round(step) must not flip
            break
    else:
        raise AssertionError("every candidate image puts step near x.5")
    got = test_bp.predict(test_bp.load_model(weights, 512, dev), img, dev)
    atol, rtol = PARITY_TOL
    for name, r in ref.items():
        g = got[name].cpu()
        err = (g - r).abs()
        bad = int((err > atol + rtol * r.abs()).sum())
        print(f"[parity] {name}: max abs err {float(err.max()):.3e}, max |ref| "
              f"{float(r.abs().max()):.3e} (atol {atol:g}, rtol {rtol:g}), {bad} outside")
        if bad or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"card forward disagrees with the CPU forward on {name}")


def _check_run(run: str, epoch: int, launches: int) -> None:
    """A train_bp run dir of one epoch: its checkpoint, finite logged losses,
    and PER_ITERATION kernel launches for each iteration."""
    from vaeplay_torch.cli import train_bp

    if launches != PER_ITERATION * TRAIN_ITERATIONS:
        raise AssertionError(f"{TRAIN_ITERATIONS} iterations launched the kernel {launches} "
                             f"times, not {PER_ITERATION} each")
    if sorted(os.listdir(run)) != [f"{epoch}.ckpt", "metrics.jsonl", "record.txt"]:
        raise AssertionError(f"run dir {run} holds {sorted(os.listdir(run))}")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    if [r["epoch"] for r in lines] != [epoch] * (TRAIN_ITERATIONS // 2) or not all(
            math.isfinite(r[k]) for r in lines for k in train_bp.AVG_KEYS):
        raise AssertionError(f"logged losses of epoch {epoch}: {lines}")
    print(f"[train] epoch {epoch}: " + "; ".join(
        " ".join(f"{k}={r[k]:.4f}" for k in train_bp.AVG_KEYS) for r in lines))


def _timed_iterations(gpu: str) -> None:
    """A warm-up and three timed training iterations at PyTorch's defaults
    (host clock, each from host batch to synchronize), the peak device
    memory, and a profile of one iteration."""
    from vaeplay_torch.cli import train_bp
    from vaeplay_torch.data.bp_data import SyntheticEmitDataset
    from vaeplay_torch.ops import attention
    from vaeplay_torch.train.state import TrainState, step_lr_every_two_epochs
    from vaeplay_torch.train.steps_bp import make_bp_train_step

    dev = torch.device("cuda", 0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = random_model().to(dev)
    state = TrainState.create(model, 1e-3, step_lr_every_two_epochs(500))
    step = make_bp_train_step(model)
    ds = SyntheticEmitDataset(img_size=IMG)
    batches = [ds.sample_batch(TRAIN_BATCH, batch_seed=s) for s in range(5)]
    for i, batch in enumerate(batches[:4]):
        before = attention.flash_attention.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step(state, *train_bp.to_device(batch, dev))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        if attention.flash_attention.launches - before != PER_ITERATION:
            raise AssertionError(f"an iteration did not launch the kernel {PER_ITERATION} times")
        if not all(bool(torch.isfinite(v)) for v in metrics.values()):
            raise AssertionError(f"non-finite losses: {metrics}")
        print(f"[train] iteration {i}{' (warm-up)' if i == 0 else ''}: {ms:.2f} ms (PyTorch "
              f"defaults: TF32 convolutions; batch {TRAIN_BATCH}, {IMG} px, two passes, host clock "
              f"incl. host-to-device copy) on {gpu}")
    print(f"[train] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated: weights, gradients, Adam moments, activations)")
    imgs, p1, p2 = train_bp.to_device(batches[4], dev)
    _profile(lambda: step(state, imgs, p1, p2), "train", runs=1)


def phase_train(tmp: str, gpu: str) -> int:
    """The training path: train_bp on cuda:0 for one epoch, a resume of it
    for a second, test_bp on the resumed run dir; then timed iterations.
    Returns the attention kernel's launches over the whole phase."""
    from vaeplay_torch.cli import test_bp, train_bp
    from vaeplay_torch.ops import attention

    attention.flash_attention.launches = 0
    common = ["--gpu", "0", "--img_size", str(IMG), "--batchsize", str(TRAIN_BATCH),
              "--iterations", str(TRAIN_ITERATIONS), "--viz_freq", "2",
              "--res_output", os.path.join(tmp, "train_results")]
    t0 = time.perf_counter()
    run = train_bp.main(common + ["--epoch", "1", "--model_output", os.path.join(tmp, "a")])
    print(f"[train] CLI run (init, {TRAIN_ITERATIONS} iterations, checkpoint) "
          f"{time.perf_counter() - t0:.2f} s: {run}")
    _check_run(run, 0, attention.flash_attention.launches)

    before = attention.flash_attention.launches
    t0 = time.perf_counter()
    resumed = train_bp.main(common + ["--epoch", "2", "--resume", run,
                                      "--model_output", os.path.join(tmp, "b")])
    print(f"[train] resumed CLI run (restore, {TRAIN_ITERATIONS} iterations, checkpoint) "
          f"{time.perf_counter() - t0:.2f} s: {resumed}")
    _check_run(resumed, 1, attention.flash_attention.launches - before)

    before = attention.flash_attention.launches
    written = test_bp.main(["--model_path", resumed, "--gpu", "0", "--img_size", str(IMG),
                            "--batchsize", "4", "--res_output", os.path.join(tmp, "bp_trained")])
    if attention.flash_attention.launches - before != PER_FORWARD or not written or not all(
            p.endswith(".png") and os.path.getsize(p) > 0 for p in written):
        raise AssertionError(f"test_bp on the trained run dir wrote {written}")
    print(f"[train] test_bp --model_path <run dir> wrote {written}")
    shutil.rmtree(os.path.join(tmp, "a"))  # two checkpoints of about 1.1 GB each
    shutil.rmtree(os.path.join(tmp, "b"))

    _timed_iterations(gpu)
    return attention.flash_attention.launches


def phase_train_parity() -> None:
    """One two-pass iteration on the card (kernel forward) and on the CPU
    (plain forward) from the same seeded weights (gammas nonzero) and batch,
    TF32 off: the seven losses, and pass 1's gradients before any update.
    Gradients, not weights: Adam's first update is about lr * sign(g), which
    turns a rounding-sized gradient near 0 into a full-sized step. The images
    are uniform noise: on a black patch the zero-bias convolutions give
    pre-activations of exactly 0, where leaky ReLU's gradient jumps, and the
    card and the CPU may round them to either side."""
    import numpy as np

    from vaeplay_torch.cli import train_bp
    from vaeplay_torch.data.bp_data import SyntheticEmitDataset
    from vaeplay_torch.train.state import TrainState
    from vaeplay_torch.train.steps_bp import loss_phase1, make_bp_train_step

    cfg = TRAIN_PARITY
    base = random_model(3, cfg["img"], cfg["channels"])
    _, p1, p2 = SyntheticEmitDataset(img_size=cfg["img"]).sample_batch(cfg["batch"], 7)
    for seed in range(20):
        imgs = np.random.default_rng(seed).uniform(
            size=(cfg["batch"], cfg["img"], cfg["img"], 3)).astype(np.float32)
        with torch.no_grad():
            step = base(torch.from_numpy(imgs))["ellipse_params"][:, 4]
        if float((step % 1.0 - 0.5).abs().min()) > 0.01:  # round(step) must not flip
            break
    else:
        raise AssertionError("every candidate batch puts step near x.5")

    results = []
    for dev in (torch.device("cpu"), torch.device("cuda", 0)):
        batch = train_bp.to_device((imgs, p1, p2), dev)
        model = copy.deepcopy(base).to(dev)
        loss_phase1(model, *batch)[0].backward()
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        _, metrics = make_bp_train_step(model)(TrainState.create(model, 1e-3), *batch)
        results.append((grads, {k: v.cpu() for k, v in metrics.items()}))
    (ref_g, ref_m), (got_g, got_m) = results
    worst_loss = max(_worst(got_m[k], ref_m[k], TRAIN_PARITY_TOL) for k in ref_m)
    worst_grad, name = max((_worst(got_g[k], ref_g[k], TRAIN_PARITY_TOL), k) for k in ref_g)
    print(f"[train parity] losses card vs CPU: " + " ".join(
        f"{k}={float(got_m[k]):.6f}/{float(ref_m[k]):.6f}" for k in ref_m))
    print(f"[train parity] worst loss at {worst_loss:.3f} of its bound, worst pass-1 gradient "
          f"at {worst_grad:.3f} of its bound ({name}); bound atol {TRAIN_PARITY_TOL[0]:g} x "
          f"max |ref| + rtol {TRAIN_PARITY_TOL[1]:g} x |ref|, {len(ref_g)} tensors")
    if worst_loss > 1 or worst_grad > 1 or not all(
            bool(torch.isfinite(t).all()) for t in list(got_g.values()) + list(got_m.values())):
        raise AssertionError("the card's training iteration disagrees with the CPU's")


def _check_vae_run(run: str, epoch: int, dtype: str) -> None:
    """A train_vae run dir of one epoch: its checkpoint and one log line of
    finite losses."""
    from vaeplay_torch.cli import train_vae
    from vaeplay_torch.train.steps_vae import METRIC_KEYS

    if sorted(os.listdir(run)) != [f"{epoch}.ckpt", "metrics.jsonl"]:
        raise AssertionError(f"run dir {run} holds {sorted(os.listdir(run))}")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    if [r["epoch"] for r in lines] != [epoch] or not all(
            math.isfinite(r[k]) for r in lines for k in METRIC_KEYS):
        raise AssertionError(f"logged losses of epoch {epoch}: {lines}")
    r = lines[0]
    print(f"[vae-train] {dtype} epoch {epoch}: " + " ".join(
        f"{k}={r[k]:.4f}" for k in train_vae.AVG_KEYS)
        + f" ({r['images_per_sec']:.1f} img/s over the epoch, CLI's host clock)")


def _vae_cli(tmp: str, name: str, dtype: str, *extra) -> str:
    from vaeplay_torch.cli import train_vae

    n = VAE_ITERATIONS[dtype]
    t0 = time.perf_counter()
    run = train_vae.main(["--gpu", "0", "--img_size", str(VAE_IMG), "--batchsize", str(VAE_BATCH),
                          "--zdim", str(VAE_Z), "--data_size", str(n * VAE_BATCH),
                          "--viz_freq", str(n), "--dtype", dtype,
                          "--res_output", os.path.join(tmp, "vae_results"),
                          "--model_output", os.path.join(tmp, name), *extra])
    print(f"[vae-train] CLI run {dtype} {' '.join(extra)} (init, {n} steps, grid, checkpoint) "
          f"{time.perf_counter() - t0:.2f} s: {run}")
    return run


def vae_flops(img: int, z: int) -> dict:
    """Forward multiply-adds x 2 of one image through the VAE-GAN's training
    forward, by sub-network, from the layer shapes: every Conv2d, transpose
    conv and Linear the forward calls (the decoder twice, on z and z_p; the
    discriminator twice, REC and GAN, over 3 images each), counted by hooks
    on a forward at batch 2 on the meta device."""
    from vaeplay_torch.models.vae_gan import VaeGan

    with torch.device("meta"):
        model = VaeGan(img_size=img, z_size=z).eval()
    flops = {}

    def count(name):
        def hook(m, inputs, out):
            x = inputs[0]
            if isinstance(m, torch.nn.ConvTranspose2d):  # each input pixel to k*k outputs
                f = 2 * x.numel() * m.out_channels * m.kernel_size[0] * m.kernel_size[1]
            elif isinstance(m, torch.nn.Conv2d):
                f = 2 * out.numel() * m.in_channels * m.kernel_size[0] * m.kernel_size[1]
            else:
                f = 2 * x.numel() * m.out_features
            flops[name] = flops.get(name, 0) + f / 2  # per image
        return hook

    for group, sub in model.named_children():
        for m in sub.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear)):
                m.register_forward_hook(count(group))
    x = torch.zeros(2, 1, img, img, device="meta")
    model(x, noise=(torch.zeros(2, z, device="meta"), torch.zeros(2, z, device="meta")))
    return flops


def _vae_timed(dtype: str, gpu: str) -> tuple:
    """A warm-up and VAE_TIMED steps of make_circle_train_step at PyTorch's
    defaults, each from the (B, 3) params on the host to synchronize, and
    the peak device memory. Returns (state, step, a further batch of params
    on the card, generator) for a profile, and the median step ms."""
    from vaeplay_torch.cli.train_vae import build_state
    from vaeplay_torch.data.circles import CircleDataset
    from vaeplay_torch.train.steps_vae import make_circle_train_step
    from vaeplay_torch.utils.amp import resolve_dtype

    dev = torch.device("cuda", 0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = build_state(VAE_IMG, VAE_Z, 1e-4, 0, dev)
    step = make_circle_train_step(state.model, VAE_IMG, resolve_dtype(dtype))
    gen = torch.Generator(device=dev).manual_seed(2)
    batches = list(CircleDataset(n=VAE_IMG, data_size=(VAE_TIMED + 2) * VAE_BATCH)
                   .epoch_batches(VAE_BATCH))
    times = []
    for i, pb in enumerate(batches[:VAE_TIMED + 1]):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step(state, torch.from_numpy(pb).to(dev), gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        if not all(bool(torch.isfinite(v)) for v in metrics.values()):
            raise AssertionError(f"non-finite losses: {metrics}")
        if i:
            times.append(ms)
        print(f"[vae-train] {dtype} step {i}{' (warm-up)' if i == 0 else ''}: {ms:.2f} ms, "
              f"{VAE_BATCH / ms * 1e3:.1f} images/s (PyTorch defaults; batch {VAE_BATCH}, "
              f"{VAE_IMG} px, z {VAE_Z}, host clock incl. the params' copy) on {gpu}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[vae-train] {dtype} peak device memory {peak:.2f} GiB "
          f"(torch.cuda.max_memory_allocated: weights, gradients, RMSprop state, activations)")
    return (state, step, torch.from_numpy(batches[-1]).to(dev), gen), sorted(times)[len(times) // 2]


def phase_vae_train(tmp: str, gpu: str) -> None:
    """The circle VAE-GAN through the train_vae CLI at bench.py's shape (256
    px, batch 128, z 128, on-device circles): bf16 for one epoch, a resume
    for a second, f32 for one epoch; then timed steps in both, the step's
    FLOPs and bound, and a profile of a bf16 step by kernel group. The
    attention kernel is on no path here: its launch count must not move."""
    from vaeplay_torch.ops import attention

    before = attention.flash_attention.launches
    run = _vae_cli(tmp, "vae_a", "bfloat16", "--epoch", "1")
    _check_vae_run(run, 0, "bfloat16")
    resumed = _vae_cli(tmp, "vae_b", "bfloat16", "--epoch", "2", "--resume", run)
    _check_vae_run(resumed, 1, "bfloat16")
    _check_vae_run(_vae_cli(tmp, "vae_c", "float32", "--epoch", "1"), 0, "float32")
    pngs = sorted(os.listdir(os.path.join(tmp, "vae_results")))
    if pngs != ["0_1.png", "0_3.png", "1_3.png"] or not all(
            os.path.getsize(os.path.join(tmp, "vae_results", p)) > 0 for p in pngs):
        raise AssertionError(f"train_vae wrote the grids {pngs}")
    print(f"[vae-train] grids {pngs}")
    for name in ("vae_a", "vae_b", "vae_c"):  # checkpoints of about 1.5 GB each
        shutil.rmtree(os.path.join(tmp, name))

    from vaeplay_torch.models.vae_gan import VaeGan

    with torch.device("meta"):
        n_params = sum(p.numel() for p in VaeGan(img_size=VAE_IMG, z_size=VAE_Z).parameters())
    flops = vae_flops(VAE_IMG, VAE_Z)
    fwd = sum(flops.values())
    step_flops = 3 * fwd * VAE_BATCH  # forward, then dgrad and wgrad in the backward
    print(f"[vae-train] {n_params / 1e6:.2f} M parameters; forward GFLOP per image from the "
          f"layer shapes: " + ", ".join(
        f"{k} {v / 1e9:.2f}" for k, v in flops.items()) + f"; total {fwd / 1e9:.2f}; "
        f"step (3 x forward x {VAE_BATCH}) {step_flops / 1e12:.2f} TFLOP, bound "
        f"{step_flops / PEAK_BF16_FLOPS * 1e3:.2f} ms at {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s "
        f"bf16, {step_flops / PEAK_TF32_FLOPS * 1e3:.2f} ms at "
        f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s TF32 (dense tensor-core rates, 700 W)")
    for dtype, peak, rate in (("float32", PEAK_TF32_FLOPS, "TF32"),
                              ("bfloat16", PEAK_BF16_FLOPS, "bf16")):
        profiled = None  # the f32 state is freed before bf16's peak is taken
        profiled, ms = _vae_timed(dtype, gpu)
        print(f"[vae-train] {dtype} median step {ms:.2f} ms, {VAE_BATCH / ms * 1e3:.1f} images/s, "
              f"{step_flops / ms / 1e9:.1f} TFLOP/s, {step_flops / peak * 1e3 / ms:.1%} of the "
              f"{rate} bound on {gpu}")
    state, step, pb, gen = profiled
    _profile(lambda: step(state, pb, gen), "vae-train", runs=1)
    del state, step, profiled
    torch.cuda.empty_cache()
    if attention.flash_attention.launches != before:
        raise AssertionError("the VAE-GAN path launched the attention kernel")


def phase_vae_parity() -> None:
    """One f32 training step of the VAE-GAN on the card and on the CPU from
    the same seeded weights, circle batch and injected noise (TF32 off): the
    five losses, every gradient, and the BatchNorm running buffers after the
    step's forward. Gradients, not weights: RMSprop's first update is about
    10 x lr x sign(g), which turns a rounding-sized gradient into a full step."""
    from vaeplay_torch.data.circles import CircleDataset
    from vaeplay_torch.models.vae_gan import VaeGan
    from vaeplay_torch.train.state import GroupedTrainState, torch_rmsprop
    from vaeplay_torch.train.steps_vae import GROUPS, METRIC_KEYS, circle_batch, vae_gan_losses

    cfg = VAE_PARITY
    base = VaeGan(img_size=cfg["img"], z_size=cfg["z"], generator=torch.Generator().manual_seed(11))
    raw = torch.from_numpy(next(CircleDataset(n=cfg["img"], data_size=cfg["batch"], seed=3)
                                .epoch_batches(cfg["batch"])))
    noise = base.draw_noise(cfg["batch"], torch.Generator().manual_seed(12), torch.device("cpu"))
    results = []
    for dev in (torch.device("cpu"), torch.device("cuda", 0)):
        model = copy.deepcopy(base).to(dev).train()
        state = GroupedTrainState.create(model, {g: torch_rmsprop(1e-4) for g in GROUPS})
        imgs, targets = circle_batch(cfg["img"], raw.to(dev))
        m = vae_gan_losses(model(imgs, noise=tuple(t.to(dev) for t in noise)), imgs, targets)
        state.zero_grad()
        sum(m[k] for k in METRIC_KEYS[:5]).backward()
        got = {f"grad {k}": p.grad.cpu() for k, p in model.named_parameters()}
        got.update({f"buffer {k}": b.cpu() for k, b in model.named_buffers()
                    if b.is_floating_point()})
        state.apply_gradients()
        results.append((got, {k: v.detach().cpu() for k, v in m.items()}))
    (ref_t, ref_m), (got_t, got_m) = results
    worst_loss, loss = max((_worst(got_m[k], ref_m[k], VAE_PARITY_TOL), k) for k in METRIC_KEYS[:5])
    worst, name = max((_worst(got_t[k], ref_t[k], VAE_PARITY_TOL), k) for k in ref_t)
    print(f"[vae parity] losses card vs CPU: " + " ".join(
        f"{k}={float(got_m[k]):.6f}/{float(ref_m[k]):.6f}" for k in METRIC_KEYS[:5]))
    print(f"[vae parity] worst loss at {worst_loss:.3f} of its bound ({loss}), worst gradient or "
          f"BN buffer at {worst:.3f} ({name}); bound atol {VAE_PARITY_TOL[0]:g} x max |ref| + "
          f"rtol {VAE_PARITY_TOL[1]:g} x |ref|, {len(ref_t)} tensors")
    if worst_loss > 1 or worst > 1 or not all(
            bool(torch.isfinite(t).all()) for t in list(got_t.values()) + list(got_m.values())):
        raise AssertionError("the card's VAE-GAN step disagrees with the CPU's")


def random_be_model(seed: int = 0, layers=(3, 4, 6, 3), width: int = 64):
    """A seeded BE ComposeNet with every FrozenBatchNorm2d's four buffers
    drawn (they start at identity, which would leave the backbone's norms
    untested): weight in [0.3, 0.8], bias and running_mean in +-0.1,
    running_var in [0.5, 1.5]."""
    from vaeplay_torch.models.backbone import FrozenBatchNorm2d
    from vaeplay_torch.models.be import ComposeNet

    model = ComposeNet(layers, width, generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, FrozenBatchNorm2d):
                for name, (lo, hi) in (("weight", (0.3, 0.8)), ("bias", (-0.1, 0.1)),
                                       ("running_mean", (-0.1, 0.1)),
                                       ("running_var", (0.5, 1.5))):
                    t = getattr(m, name)
                    t.copy_(lo + (hi - lo) * torch.rand(t.shape, generator=g))
    return model


def be_flops(img: int) -> dict:
    """Multiply-adds x 2 of one image through BE's training forward and its
    backward, by part (body, fpn, aux, heads), from the layer shapes: every
    Conv2d the forward calls, counted by hooks on a train-mode forward at
    batch 2 on the meta device, with the stem and layer1 frozen. The
    backward of a convolution costs its forward once for the weight
    gradient, if the weight trains, and once for the input gradient, if its
    input needs one. Returns {"forward": {part: flops}, "backward": {...}}."""
    from vaeplay_torch.models.be import ComposeNet
    from vaeplay_torch.train.state import freeze_backbone_stem

    with torch.device("meta"):
        model = ComposeNet().train()
    freeze_backbone_stem(model)
    out = {"forward": {}, "backward": {}}

    def count(part):
        def hook(m, inputs, y):
            x = inputs[0]
            f = 2 * y.numel() // y.shape[0] * (m.in_channels // m.groups) * math.prod(m.kernel_size)
            out["forward"][part] = out["forward"].get(part, 0) + f
            out["backward"][part] = out["backward"].get(part, 0) + f * (
                int(m.weight.requires_grad) + int(x.requires_grad))
        return hook

    for name, m in model.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            part = ("body" if ".body." in name else "fpn" if ".fpn." in name
                    else "aux" if "aux_convs" in name else "heads")
            m.register_forward_hook(count(part))
    model(torch.zeros(2, 3, img, img, device="meta"))
    return out


def _be_grids(root: str) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files if f.endswith(".png"))


def phase_be_infer(tmp: str, gpu: str) -> float:
    """BE inference through the test_be CLI on cuda:0 at 512 px, batch 8;
    then timed batches, the peak memory, the bound and a profile. Returns
    the median batch ms."""
    from vaeplay_torch.cli import test_be
    from vaeplay_torch.data.be_data import SyntheticBubbleDataset

    dev = torch.device("cuda", 0)
    weights = os.path.join(tmp, "be_random.pt")
    torch.save(random_be_model(0).state_dict(), weights)
    t0 = time.perf_counter()
    written = test_be.main(["--model_path", weights, "--gpu", "0", "--img_size", str(BE_IMG),
                            "--batchsize", str(BE_INFER_BATCH),
                            "--res_output", os.path.join(tmp, "be_test")])
    print(f"[be-infer] CLI run (load, two batches of {BE_INFER_BATCH} at {BE_IMG} px, grids) "
          f"{time.perf_counter() - t0:.2f} s; wrote {written}")
    if len(written) != 2 or not all(os.path.getsize(p) > 0 for p in written):
        raise AssertionError(f"test_be wrote {written}")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = test_be.load_model(weights, dev)
    ds = SyntheticBubbleDataset(img_size=BE_IMG, data_size=4 * BE_INFER_BATCH, seed=5)
    batches = [b["imgs"] for b in ds.epoch_batches(BE_INFER_BATCH)]
    times = []
    for i, imgs in enumerate(batches):
        torch.cuda.synchronize()
        t = time.perf_counter()
        preds = test_be.predict(model, imgs, dev)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        for k, p in preds.items():
            if tuple(p.shape) != (BE_INFER_BATCH, 1, BE_IMG, BE_IMG) or not bool(
                    ((p >= 0) & (p <= 1)).all()):
                raise AssertionError(f"{k}: shape {tuple(p.shape)} or values outside [0, 1]")
        if i:
            times.append(ms)
        print(f"[be-infer] batch {i}{' (warm-up)' if i == 0 else ''}: {ms:.2f} ms (PyTorch "
              f"defaults: TF32 convolutions; batch {BE_INFER_BATCH}, {BE_IMG} px, host clock incl. "
              f"host-to-device copy and sigmoid) on {gpu}")
    print(f"[be-infer] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated: weights and activations)")
    fwd = sum(be_flops(BE_IMG)["forward"].values()) * BE_INFER_BATCH
    median = sorted(times)[len(times) // 2]
    print(f"[be-infer] forward {fwd / 1e12:.3f} TFLOP a batch (convolutions), bound "
          f"{fwd / PEAK_TF32_FLOPS * 1e3:.3f} ms at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s TF32; "
          f"median batch {median:.2f} ms, {BE_INFER_BATCH / median * 1e3:.1f} images/s, "
          f"{fwd / PEAK_TF32_FLOPS * 1e3 / median:.1%} of the bound on {gpu}")
    _profile(lambda: test_be.predict(model, batches[1], dev), "be-infer")
    return median


def _check_be_run(run: str, epoch: int, dtype: str) -> None:
    """A train_be run dir of one epoch: its checkpoint and one log line of
    finite losses."""
    from vaeplay_torch.train.steps_be import METRIC_KEYS

    if sorted(os.listdir(run)) != [f"{epoch}.ckpt", "metrics.jsonl", "record.txt"]:
        raise AssertionError(f"run dir {run} holds {sorted(os.listdir(run))}")
    with open(os.path.join(run, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    if [r["epoch"] for r in lines] != [epoch] or not all(
            math.isfinite(r[k]) for r in lines for k in METRIC_KEYS):
        raise AssertionError(f"logged losses of epoch {epoch}: {lines}")
    r = lines[0]
    print(f"[be-train] {dtype} epoch {epoch}: " + " ".join(f"{k}={r[k]:.4f}" for k in METRIC_KEYS)
          + f" ({r['images_per_sec']:.1f} img/s over the epoch, CLI's host clock)")


def _be_cli(tmp: str, name: str, dtype: str, *extra) -> str:
    from vaeplay_torch.cli import train_be

    n = BE_ITERATIONS[dtype]
    t0 = time.perf_counter()
    run = train_be.main(["--gpu", "0", "--img_size", str(BE_IMG), "--batchsize",
                         str(BE_TRAIN_BATCH), "--iterations", str(n), "--viz_freq", str(n),
                         "--dtype", dtype, "--res_output", os.path.join(tmp, "be_results"),
                         "--model_output", os.path.join(tmp, name), *extra])
    print(f"[be-train] CLI run {dtype} {' '.join(extra)} (init, {n} iterations, grid, "
          f"checkpoint) {time.perf_counter() - t0:.2f} s: {run}")
    return run


def _be_timed(dtype: str, gpu: str) -> tuple:
    """A warm-up and BE_TIMED steps of make_bubble_train_step at PyTorch's
    defaults, each from the (B, 5) table on the host to synchronize (render,
    augmentation, forward, backward, Adam), and the peak device memory.
    Returns (state, step, a further table on the card, generator) for a
    profile, and the median step ms."""
    from vaeplay_torch.cli.train_be import build_state
    from vaeplay_torch.data.be_data import SyntheticBubbleDataset
    from vaeplay_torch.train.steps_be import make_bubble_train_step
    from vaeplay_torch.utils.amp import resolve_dtype

    dev = torch.device("cuda", 0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = build_state(1e-4, 0, dev)
    state.model.train()
    step = make_bubble_train_step(state.model, BE_IMG, resolve_dtype(dtype))
    gen = torch.Generator(device=dev).manual_seed(1)
    tables = [p for p, _ in SyntheticBubbleDataset(
        img_size=BE_IMG, data_size=(BE_TIMED + 2) * BE_TRAIN_BATCH).epoch_params(BE_TRAIN_BATCH)]
    times = []
    for i, table in enumerate(tables[:BE_TIMED + 1]):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step(state, torch.from_numpy(table).to(dev), gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        if not all(bool(torch.isfinite(v)) for v in metrics.values()):
            raise AssertionError(f"non-finite losses: {metrics}")
        if i:
            times.append(ms)
        print(f"[be-train] {dtype} step {i}{' (warm-up)' if i == 0 else ''}: {ms:.2f} ms, "
              f"{BE_TRAIN_BATCH / ms * 1e3:.1f} images/s (PyTorch defaults; batch "
              f"{BE_TRAIN_BATCH}, {BE_IMG} px, host clock incl. the table's copy) on {gpu}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[be-train] {dtype} peak device memory {peak:.2f} GiB "
          f"(torch.cuda.max_memory_allocated: weights, gradients, Adam moments, activations)")
    return ((state, step, torch.from_numpy(tables[-1]).to(dev), gen),
            sorted(times)[len(times) // 2])


def phase_be_train(tmp: str, gpu: str) -> dict:
    """BE through the train_be CLI at 512 px, batch 32: bf16 for one epoch,
    a resume for a second, f32 for one epoch, test_be on the resumed run
    dir; then the step's FLOPs and bound, timed steps and a profile in each
    dtype. Returns the median step ms by dtype."""
    from vaeplay_torch.cli import test_be

    run = _be_cli(tmp, "be_a", "bfloat16", "--epoch", "1")
    _check_be_run(run, 0, "bfloat16")
    resumed = _be_cli(tmp, "be_b", "bfloat16", "--epoch", "2", "--resume", run)
    _check_be_run(resumed, 1, "bfloat16")
    _check_be_run(_be_cli(tmp, "be_c", "float32", "--epoch", "1"), 0, "float32")
    grids = _be_grids(os.path.join(tmp, "be_results"))
    if sorted(os.path.basename(g) for g in grids) != ["0_2.png", "0_3.png", "1_3.png"]:
        raise AssertionError(f"train_be wrote the grids {grids}")
    written = test_be.main(["--model_path", resumed, "--gpu", "0", "--img_size", str(BE_IMG),
                            "--batchsize", str(BE_INFER_BATCH),
                            "--res_output", os.path.join(tmp, "be_trained")])
    if len(written) != 2 or not all(os.path.getsize(p) > 0 for p in written):
        raise AssertionError(f"test_be on the trained run dir wrote {written}")
    print(f"[be-train] grids {grids}; test_be --model_path <run dir> wrote {written}")
    for name in ("be_a", "be_b", "be_c"):
        shutil.rmtree(os.path.join(tmp, name))

    from vaeplay_torch.models.be import ComposeNet
    from vaeplay_torch.train.state import is_frozen_backbone_param

    with torch.device("meta"):
        model = ComposeNet()
        n_params = sum(p.numel() for p in model.parameters())
        n_frozen = sum(p.numel() for n, p in model.named_parameters()
                       if is_frozen_backbone_param(n))
    flops = be_flops(BE_IMG)
    fwd, bwd = sum(flops["forward"].values()), sum(flops["backward"].values())
    step_flops = (fwd + bwd) * BE_TRAIN_BATCH
    print(f"[be-train] {n_params / 1e6:.2f} M parameters ({n_frozen / 1e6:.2f} M frozen); "
          f"GFLOP per image from the layer shapes, forward: " + ", ".join(
              f"{k} {v / 1e9:.2f}" for k, v in flops["forward"].items())
          + f" (total {fwd / 1e9:.2f}); backward: " + ", ".join(
              f"{k} {v / 1e9:.2f}" for k, v in flops["backward"].items())
          + f" (total {bwd / 1e9:.2f}); step ({BE_TRAIN_BATCH} images) "
          f"{step_flops / 1e12:.2f} TFLOP, bound {step_flops / PEAK_BF16_FLOPS * 1e3:.2f} ms at "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16, {step_flops / PEAK_TF32_FLOPS * 1e3:.2f} ms "
          f"at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s TF32 (dense tensor-core rates, 700 W)")
    medians = {}
    for dtype, peak, rate in (("bfloat16", PEAK_BF16_FLOPS, "bf16"),
                              ("float32", PEAK_TF32_FLOPS, "TF32")):
        profiled = None  # the previous state is freed before this peak is taken
        profiled, ms = _be_timed(dtype, gpu)
        medians[dtype] = ms
        print(f"[be-train] {dtype} median step {ms:.2f} ms, {BE_TRAIN_BATCH / ms * 1e3:.1f} "
              f"images/s, {step_flops / ms / 1e9:.1f} TFLOP/s, {step_flops / peak * 1e3 / ms:.1%} "
              f"of the {rate} bound on {gpu}")
        state, step, table, gen = profiled
        _profile(lambda: step(state, table, gen), f"be-train {dtype}", runs=1)
        del state, step, table, gen
    del profiled
    torch.cuda.empty_cache()
    return medians


def phase_be_parity() -> None:
    """One BE training step on the card and on the CPU from the same seeded
    weights (random FrozenBatchNorm constants), noise images and bubble
    masks, TF32 off, in f32 and in f64. f32: both losses and every buffer
    after the step's forward (the BatchNorms' running statistics). f64: the
    losses, every gradient and every buffer. The f32 gradients are not held:
    they are ill-conditioned here (the aux chain's BatchNorm biases get sums
    that nearly cancel, behind a conv and a train-mode BatchNorm), so that
    the CPU's own f32 gradients differ from its f64 ones by up to 1.9e-2 of a
    tensor's largest magnitude, and two f32 backends cannot agree within
    1e-3. Gradients, not weights: Adam's first update is about lr x sign(g).
    The images are noise, so that no convolution output is exactly 0 at a
    ReLU; the max pool's ties sit before the frozen layer1, where no
    gradient flows."""
    import numpy as np

    from vaeplay_torch.data.be_data import render_bubble_batch, sample_bubble_params
    from vaeplay_torch.train.state import frozen_backbone_adam
    from vaeplay_torch.train.steps_be import METRIC_KEYS, make_be_train_step

    cfg = BE_PARITY
    base = random_be_model(7)
    imgs = torch.from_numpy(np.random.default_rng(3).uniform(
        size=(cfg["batch"], 3, cfg["img"], cfg["img"])))
    table = torch.from_numpy(sample_bubble_params(cfg["img"], cfg["batch"], seed=4)[0])
    masks = render_bubble_batch(cfg["img"], table)[1:]
    for dtype in (torch.float32, torch.float64):
        results = []
        for dev in (torch.device("cpu"), torch.device("cuda", 0)):
            model = copy.deepcopy(base).to(dev, dtype).train()
            state = frozen_backbone_adam(model, 1e-4)
            batch = [t.to(dev, dtype) for t in (imgs, *masks)]
            _, m = make_be_train_step(model)(state, *batch)
            got = {f"buffer {k}": b.cpu() for k, b in model.named_buffers()
                   if b.is_floating_point()}
            if dtype == torch.float64:
                got.update({f"grad {k}": p.grad.cpu() for k, p in model.named_parameters()
                            if p.grad is not None})
            results.append((got, {k: v.cpu() for k, v in m.items()}))
        (ref_t, ref_m), (got_t, got_m) = results
        if sorted(ref_t) != sorted(got_t):
            raise AssertionError("the card and the CPU computed gradients of different tensors")
        tol = BE_PARITY_TOL[dtype]
        worst_loss, loss = max((_worst(got_m[k], ref_m[k], tol), k) for k in METRIC_KEYS)
        worst, name = max((_worst(got_t[k], ref_t[k], tol,
                                  float(ref_t[BE_ZERO_GRADS[k]].abs().max())
                                  if k in BE_ZERO_GRADS else None), k) for k in ref_t)
        n_grads = sum(k.startswith("grad") for k in ref_t)
        label = str(dtype)[6:]
        print(f"[be parity] {label} losses card vs CPU: " + " ".join(
            f"{k}={float(got_m[k]):.6f}/{float(ref_m[k]):.6f}" for k in METRIC_KEYS))
        print(f"[be parity] {label}: worst loss at {worst_loss:.2e} of its bound ({loss}), worst "
              f"gradient or buffer at {worst:.2e} ({name}); bound atol {tol[0]:g} x max |ref| + "
              f"rtol {tol[1]:g} x |ref|; {n_grads} gradients, {len(ref_t) - n_grads} buffers")
        if worst_loss > 1 or worst > 1 or not all(
                bool(torch.isfinite(t).all()) for t in list(got_t.values()) + list(got_m.values())):
            raise AssertionError(f"the card's {label} BE step disagrees with the CPU's")


def profile_only(gpu: str) -> None:
    """Phase 3's profile alone, at the same weights and batch."""
    from vaeplay_torch.cli import test_bp
    from vaeplay_torch.data.bp_data import SyntheticEmitDataset

    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix=".smoke-", dir=ROOT) as tmp:
        weights = os.path.join(tmp, "bp_random.pt")
        random_weights(weights)
        model = test_bp.load_model(weights, 512, dev)
    imgs = SyntheticEmitDataset(img_size=512, data_size=16).sample_batch(4, batch_seed=1)[0]
    test_bp.predict(model, imgs, dev)
    _profile(lambda: test_bp.predict(model, imgs, dev), "slice")
    print(gpu)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    gpu = gpu_line()
    phase_build()
    if argv == ["--profile-only"]:
        profile_only(gpu)
        return 0
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    from vaeplay_torch.ops import attention

    with strict_f32():
        kernel = phase_kernels(gpu)
        phase_kernel_backward(gpu)
    with tempfile.TemporaryDirectory(prefix=".smoke-", dir=ROOT) as tmp:
        weights = os.path.join(tmp, "bp_random.pt")
        random_weights(weights)
        kernel["launches"] = phase_slice(tmp, weights, gpu)
        with strict_f32():
            phase_parity(weights)
        kernel["launches"] += phase_train(tmp, gpu)
        phase_vae_train(tmp, gpu)
        before = attention.flash_attention.launches
        phase_be_infer(tmp, gpu)
        phase_be_train(tmp, gpu)
        if attention.flash_attention.launches != before:
            raise AssertionError("a BE phase launched the attention kernel")
    with strict_f32():
        phase_train_parity()
        phase_vae_parity()
        before = attention.flash_attention.launches
        phase_be_parity()
        if attention.flash_attention.launches != before:
            raise AssertionError("the BE parity step launched the attention kernel")
    print(gpu)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
