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
              the PyTorch library call.
3. slice   -- BP inference through the port's test_bp CLI at 512 px, batch 4,
              the full emit-channel pyramid, seeded random weights with every
              attention gamma nonzero: one CLI run that must write a PNG,
              then a warm-up and three timed synthetic batches, at PyTorch's
              default precision and again in strict f32, and a profile of a
              few more forwards. Every forward must launch the attention
              kernel exactly 9 times.
4. parity  -- the same weights and image at batch 1: the card's forward
              (kernels) against the port's CPU forward (plain versions).

It prints the card's name and power limit, one JSON line describing the
kernels, and as its last line {"ok": true, "device": {...}}. It exits
non-zero without a result when no CUDA device is present.

    python3 chip_smoke.py --profile-only

builds the kernels and runs only phase 3's profile (the device time of a BP
forward by kernel group); run from another checkout of the repo, it profiles
that checkout's package, so two versions compare with one script.
"""

import contextlib
import json
import os
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
PARITY_TOL = (1e-3, 1e-3)  # card forward vs CPU forward, see phase_parity
PER_FORWARD = 9  # attention launches: 3 ValueEncoder + 3 tower-a + 3 tower-b blocks


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
    b, n, dk, dv = BP_SHAPE
    times = {}
    for layout in ("c", "n"):
        q, k, v = _qkv(BP_SHAPE, torch.float32, seed=0, layout=layout)
        out = (torch.empty(b, dv, n, device="cuda").transpose(1, 2) if layout == "c"
               else torch.empty(b, n, dv, device="cuda"))
        q4, k4, v4 = q[:, None], k[:, None], v[:, None]
        times[layout] = (
            cuda_ms(lambda: attention.flash_attention(q, k, v, out=out)),
            cuda_ms(lambda: attention.reference_attention(q, k, v)),
            cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k4, v4, scale=1.0)))
    ms, plain_ms, library_ms = times["c"]
    flops = 2.0 * b * n * n * (dk + dv)
    nbytes = 4.0 * (2 * b * n * dk + 2 * b * n * dv)
    t_ops = TF32_PASSES * flops / PEAK_TF32_FLOPS * 1e3
    t_cuda_core = flops / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    print(f"[kernels] BP shape f32, channel-major, on {gpu}: kernel_ms {ms:.4f}, "
          f"plain_ms {plain_ms:.4f}, library_ms {library_ms:.4f}, bound_ms {bound_ms:.4f} "
          f"({TF32_PASSES} x {flops / 1e9:.2f} GFLOP at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s "
          f"TF32; {nbytes / 1e6:.1f} MB), bound_f32_cuda_core_ms {t_cuda_core:.4f}; "
          f"kernel at {flops / ms / 1e9:.1f} TFLOP/s counted once, "
          f"{bound_ms / ms:.1%} of its bound")
    print(f"[kernels] BP shape f32, position-major, on {gpu}: flash_attention_ms "
          f"(copies of k and v, then the kernel) {times['n'][0]:.4f}, "
          f"plain_ms {times['n'][1]:.4f}, library_ms {times['n'][2]:.4f}")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "vaeplay_torch/ops/csrc/flash_attention.cu",
            "replaces": "vaeplay_tpu/ops/attention.py:37", "engine": ENGINE,
            "launches": None, "max_abs_err": bp_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms}


def random_weights(path: str, seed: int = 0) -> None:
    """Seeded random ComposeNet weights at 512 px with the full emit-channel
    pyramid, every attention gamma drawn from +-[0.2, 0.6] (it starts at 0,
    which would hide the attention output), saved as the CLI's --model_path
    reads them."""
    from vaeplay_torch.models.bp import ComposeNet

    model = ComposeNet(image_size=512, generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    sd = model.state_dict()
    for key in sd:
        if key.endswith(".gamma"):
            sign = 1.0 if torch.rand(1, generator=g).item() < 0.5 else -1.0
            sd[key] = sign * (0.2 + 0.4 * torch.rand(1, generator=g))
    torch.save(sd, path)


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


def _profile(model, imgs, dev, forwards: int = 3) -> None:
    """Device time by kernel over a few forwards (after one profiled warm-up,
    which pays CUPTI's start-up), against their wall time."""
    from torch.profiler import ProfilerActivity, profile

    from vaeplay_torch.cli import test_bp

    for n in (1, forwards):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(n):
                test_bp.predict(model, imgs, dev)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3 / n
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy = sum(e.self_device_time_total for e in events) / 1e3 / forwards
    print(f"[slice] profiled forward (PyTorch defaults): {busy:.2f} ms device busy, "
          f"{wall:.2f} ms wall, idle share {max(0.0, 1 - busy / wall):.3f}, "
          f"{sum(e.count for e in events) // forwards} device activities")
    groups = {}
    for e in events:
        name = e.key
        group = ("attention kernel" if "flash_attention" in name
                 else "host-to-device copy" if "Memcpy" in name
                 else "tensor copies (.contiguous, layout)" if "copy" in name
                 else "cuDNN NCHW<->NHWC transposes" if any(t in name for t in ("nchwToNhwc",
                                                                               "nhwcToNchw"))
                 else "convolution" if any(t in name for t in ("conv", "fprop", "Nhwc", "Nchw"))
                 else "gemm" if "gemm" in name
                 else "elementwise and other")
        groups[group] = groups.get(group, 0.0) + e.self_device_time_total / 1e3 / forwards
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[slice]   {ms:8.3f} ms  {group}")
    for e in events[:12]:
        print(f"[slice]   {e.self_device_time_total / 1e3 / forwards:8.3f} ms  "
              f"x{e.count // forwards:<3d} {e.key[:90]}")


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
    _profile(model, batches[1], dev)
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
    _profile(model, imgs, dev)
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
    with strict_f32():
        kernel = phase_kernels(gpu)
    with tempfile.TemporaryDirectory(prefix=".smoke-", dir=ROOT) as tmp:
        weights = os.path.join(tmp, "bp_random.pt")
        random_weights(weights)
        kernel["launches"] = phase_slice(tmp, weights, gpu)
        with strict_f32():
            phase_parity(weights)
    print(gpu)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
