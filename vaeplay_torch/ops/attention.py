"""Spatial / point-set self-attention.

Port of vaeplay_tpu/ops/attention.py. Semantics (the reference's, exactly):

  attn[b, i, j] = softmax_j(q[b, i, :] . k[b, j, :])   (NO 1/sqrt(d) scaling)
  out[b, i, :]  = sum_j attn[b, i, j] * v[b, j, :]

`spatial_self_attention` runs through the `SpatialAttention` autograd
Function, whose forward sends a CPU tensor to the plain version
`reference_attention` and a CUDA tensor to a hand-written kernel (through
`flash_attention`): f32 operands to `csrc/flash_attention.cu` (3xTF32), bf16
operands to `csrc/flash_attention_bf16.cu` (bf16 wgmma, the TPU kernel's
default arithmetic), for every N. Its backward sends a CPU tensor to
`attention_backward`, the JAX package's recompute VJP
(`_pallas_attention_bwd`) as plain f32 batched matrix products, and a CUDA
tensor to the hand-written backward `csrc/flash_attention_bwd.cu` (through
`flash_attention_backward`): the same gradients with f32-accurate products
on the tensor cores and no N x N buffer, P recomputed from the row
log-sum-exp that the forward kernel writes when a gradient is needed, with
a flag on each row whose softmax is one-hot (ONE_HOT): there the backward
takes dS as 0 and P as 1 at the row's max, as the plain version has them,
since a recomputed score differs from the forward's by a rounding that
large unscaled scores make larger than 1. One departure with bf16 operands: the kernel takes delta = g . out from the
forward's bf16 output, where the plain version recomputes the output in
f32, so its dq and dk lie up to about 5e-3 of their largest magnitude from
the plain ones (dv, which delta does not reach, agrees to f32 rounding).
There is no fallback on a CUDA tensor: a kernel launches or the call
raises.

Shapes are (B, N, C) throughout. `flash_attention` takes each of q, k, v in
either of two layouts: position-major (channel stride 1, a contiguous
(B, N, C)) or channel-major (position stride 1, the (B, N, C) transpose view
of a contiguous (B, C, N), which is how an NCHW activation holds its
positions), in f32 or bf16, and writes the result in their dtype. The
kernels read q with any strides, and k and v where the model leaves them:
by the TMA engine when they are channel-major with 16-byte aligned rows
(route "tma"), else by the threads' own loads (route "direct": BC's N =
258, BE_font's N = 1, an address off 16 bytes). Only a position-major k or
v, which no model path passes, is copied first, into the TMA's form.

`RingRouting` (the JAX module's, :150-175) sends a position axis long enough
through the ring over a mesh's "model" ranks (parallel/ring_attention.py)
instead: a model built with the handle consults it, one built without never
rings.
"""

import ctypes
import dataclasses
from typing import Any, Optional

import torch
from torch.autograd.function import once_differentiable

from vaeplay_torch.ops import _build

MAX_DK = 128  # the kernels' limit (MAX_DK in csrc/flash_attention*.cu)
# dtype -> (library, C function) of its kernel
_KERNELS = {torch.float32: ("flash_attention", "flash_attention_fwd"),
            torch.bfloat16: ("flash_attention_bf16", "flash_attention_fwd_bf16")}
# the launch counts by route (flash_attention.routes)
ROUTES = tuple(f"{str(dt)[6:]}/{r}" for dt in _KERNELS for r in ("tma", "direct"))
# dtype -> C function of the backward (library flash_attention_bwd)
_BACKWARD = {torch.float32: "flash_attention_bwd", torch.bfloat16: "flash_attention_bwd_bf16"}


def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    """f32, or f64 for f64 inputs (which the CPU gradient checks use)."""
    return torch.promote_types(t.dtype, torch.float32)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version: (B, N, Dk), (B, N, Dk), (B, N, Dv) -> (B, N, Dv), any
    strides. Scores and softmax in f32 (f64 for f64 inputs); the
    probabilities rounded to v's dtype before P.V, which sums in f32, and the
    result in v's dtype: with bf16 operands the arithmetic of the JAX
    package's `_reference_attention` and of the bf16 kernel."""
    ct = _compute_dtype(q)
    energy = torch.bmm(q.to(ct), k.to(ct).transpose(1, 2))
    attn = torch.softmax(energy, dim=-1).to(v.dtype).to(ct)
    return torch.bmm(attn, v.to(ct)).to(v.dtype)


# a row of softmax(S) is one-hot where its other keys hold under ONE_HOT of
# its sum of exp(S - max), the max's own term being 1 (csrc/hopper.cuh)
ONE_HOT = 2.0 ** -20


def reference_lse(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Plain version of what the forward kernels write for the backward, a
    (2, B, N) in f32 (f64 for f64 inputs): each query row's log of sum_j
    exp(q_i . k_j), and 1 where the row is one-hot (ONE_HOT), else 0."""
    ct = _compute_dtype(q)
    s = torch.bmm(q.to(ct), k.to(ct).transpose(1, 2))
    m = s.amax(dim=-1, keepdim=True)
    sums = torch.exp(s - m).sum(dim=-1)
    return torch.stack((m[..., 0] + torch.log(sums), (sums <= 1 + ONE_HOT).to(ct)))


def _channel_major(name: str, t: torch.Tensor) -> bool:
    """False when t's channels are contiguous, True when its positions are;
    raises for any other layout."""
    if t.stride(2) == 1 or t.shape[2] == 1:
        return False
    if t.stride(1) == 1 or t.shape[1] == 1:
        return True
    raise ValueError(f"flash_attention: {name} needs channel stride 1 or position stride 1, "
                     f"got strides {t.stride()}")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    _check_operands(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("flash_attention: the kernel wrapper records no gradient; call "
                           "spatial_self_attention, whose autograd Function has the backward")


def _check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention: {name} is on {t.device}, not a CUDA device")
        if t.dim() != 3:
            raise ValueError(f"flash_attention: {name} must be (B, N, D), got {tuple(t.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("flash_attention: q, k, v must share one dtype and device")
    if q.dtype not in _KERNELS:
        raise ValueError(f"flash_attention: dtype {q.dtype} is not float32 or bfloat16")
    b, n, dk = q.shape
    if k.shape != q.shape or v.shape[:2] != (b, n):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if not (0 < dk <= MAX_DK) or n == 0 or v.shape[2] == 0 or not (0 < b <= 65535):
        raise ValueError(f"flash_attention: needs 0 < Dk <= {MAX_DK}, N > 0, Dv > 0 and "
                         f"0 < B <= 65535; got q {tuple(q.shape)}, v {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _channel_major(name, t)


def _check_lse(lse: torch.Tensor, q: torch.Tensor) -> None:
    b, n, _ = q.shape
    if (lse.shape != (2, b, n) or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention: lse must be a contiguous {(2, b, n)} float32 on "
                         f"{q.device}, got {tuple(lse.shape)} {lse.dtype} on {lse.device}")


def _check_out(out: torch.Tensor, v: torch.Tensor) -> None:
    b, n, dv = v.shape
    if out.shape != (b, n, dv) or out.dtype != v.dtype or out.device != v.device:
        raise ValueError(f"flash_attention: out must be {(b, n, dv)} {v.dtype} on {v.device}, "
                         f"got {tuple(out.shape)} {out.dtype} on {out.device}")
    if not (out.is_contiguous() or out.transpose(1, 2).is_contiguous()):
        raise ValueError("flash_attention: out must be a contiguous (B, N, Dv) or the "
                         "transpose view of a contiguous (B, Dv, N)")


def operand_route(t: torch.Tensor) -> str:
    """How the kernel reads k or v: "tma" (channel-major, or one position,
    with the address and the channel and batch strides multiples of 16
    bytes), "copy" (position-major: copied into that form first) or "direct"
    (the threads load it from its strides)."""
    b, n, _ = t.shape
    s0, s1, s2 = t.stride()
    if n > 1 and s1 != 1:
        return "copy"
    size = t.element_size()
    if (t.data_ptr() % 16 == 0 and s2 > 0 and s2 * size % 16 == 0
            and (b == 1 or (s0 > 0 and s0 * size % 16 == 0))):
        return "tma"
    return "direct"


def kernel_operands(k: torch.Tensor, v: torch.Tensor):
    """(k, v, route) as the kernel reads them: both in place by the threads
    ("direct") when either needs it; else both by the TMA engine, a
    position-major one after one copy into a (B, C, N') buffer of its dtype,
    N' the next multiple of 16 bytes of positions, returned as its (B, N, C)
    view. flash_attention.copied_bytes counts what the copies wrote."""
    routes = operand_route(k), operand_route(v)
    if "direct" in routes:
        return k, v, "direct"
    out = []
    for t, route in zip((k, v), routes):
        if route == "copy":
            b, n, c = t.shape
            per_row = 16 // t.element_size()
            buf = torch.empty((b, c, -(-n // per_row) * per_row), dtype=t.dtype, device=t.device)
            t = buf[:, :, :n].transpose(1, 2).copy_(t)
            flash_attention.copied_bytes += buf.numel() * buf.element_size()
        out.append(t)
    return out[0], out[1], "tma"


_FUNCTIONS = {}  # (library, C function) -> the function, bound at first use
_STRIDES = {}  # the strides of a call -> their ctypes array, built once


def _function(library: str, function: str):
    fn = _FUNCTIONS.get((library, function))
    if fn is None:
        fn = _FUNCTIONS[library, function] = getattr(_build.load(library), function)
    return fn


def _strides(*tensors: torch.Tensor):
    key = sum((t.stride() for t in tensors), ())
    strides = _STRIDES.get(key)
    if strides is None:
        strides = _STRIDES[key] = (ctypes.c_longlong * len(key))(*key)
    return strides


def _call(name: str, fn, device: torch.device, *args) -> None:
    """fn(*args, the device's current stream) on that device; raises on a
    CUDA error."""
    index = device.index
    # the current stream's handle (torch.cuda.current_stream(index).cuda_stream
    # without building a Stream object: a few microseconds a call)
    args += (torch._C._cuda_getCurrentRawStream(index),)
    if index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: Optional[torch.Tensor] = None,
                    lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel of q's dtype on PyTorch's current stream and return
    `out` (by default a new contiguous (B, N, Dv)), written by the kernel in
    that dtype; where `lse` (a contiguous f32 (2, B, N)) is given, the
    kernel also writes into it what the backward reads, as reference_lse
    gives it: each query row's log-sum-exp, and its one-hot flag.
    CUDA tensors only; raises on anything the kernels do not take.
    `flash_attention.launches` counts the launches, `.routes` them by dtype
    and route (ROUTES), `.copied_bytes` the bytes of operand copies;
    `reset_counts()` sets them to 0."""
    _check(q, k, v)
    b, n, dk = q.shape
    dv = v.shape[2]
    if out is None:
        out = torch.empty((b, n, dv), dtype=v.dtype, device=v.device)
    else:
        _check_out(out, v)
    if lse is not None:
        _check_lse(lse, q)
    k_in, v_in, route = kernel_operands(k, v)
    _call("flash_attention", _function(*_KERNELS[q.dtype]), q.device, q.data_ptr(),
          k_in.data_ptr(), v_in.data_ptr(), out.data_ptr(),
          None if lse is None else lse.data_ptr(), b, n, dk, dv,
          _strides(q, k_in, v_in, out), int(route == "direct"))
    flash_attention.launches += 1
    flash_attention.routes[f"{str(q.dtype)[6:]}/{route}"] += 1
    return out


def _gradient_channel_major(like: torch.Tensor) -> bool:
    """Whether the gradient of `like` is made channel-major (the transpose
    view of a contiguous (B, C, N)): where `like` is, so that the NCHW
    convolution behind it takes the gradient with no copy."""
    return like.stride(2) != 1 and like.stride(1) == 1


def _grad_buffer(like: torch.Tensor) -> torch.Tensor:
    """An empty gradient for `like`, in the layout attention_backward gives."""
    b, n, c = like.shape
    if _gradient_channel_major(like):
        return torch.empty((b, c, n), dtype=like.dtype, device=like.device).transpose(1, 2)
    return torch.empty((b, n, c), dtype=like.dtype, device=like.device)


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor):
    """(dq, dk, dv) of softmax(q kᵀ) v for the output gradient g, by the
    hand-written backward of q's dtype on PyTorch's current stream: `out`
    and `lse` are what flash_attention wrote for these q, k, v (P is
    recomputed from lse, delta from out and g: with bf16 operands the bf16
    out, see the module's note). q, k, v as flash_attention
    takes them, g any strides; each gradient has its input's dtype and, where
    that input is channel-major, its layout. CUDA tensors only; raises on
    anything the kernel does not take. `flash_attention_backward.launches`
    counts the calls; `reset_counts()` sets it to 0."""
    _check_operands(q, k, v)
    _check_lse(lse, q)
    b, n, dk = q.shape
    dv = v.shape[2]
    for name, t in (("out", out), ("g", g)):
        if t.shape != (b, n, dv) or t.dtype != v.dtype or t.device != v.device:
            raise ValueError(f"flash_attention_backward: {name} must be {(b, n, dv)} {v.dtype} "
                             f"on {v.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    dq, dk_, dv_ = _grad_buffer(q), _grad_buffer(k), _grad_buffer(v)
    # f32 scratch, written by the kernel: delta and the two row offsets of S
    # (3, B, N), and dq and dk summed
    # over the blocks that share them (B, N, Dk rounded up to a multiple of 8)
    delta = torch.empty((3, b, n), dtype=torch.float32, device=q.device)
    dq_acc, dk_acc = torch.empty((2, b, n, -(-dk // 8) * 8), dtype=torch.float32,
                                 device=q.device)
    _call("flash_attention_backward", _function("flash_attention_bwd", _BACKWARD[q.dtype]),
          q.device, *(t.data_ptr() for t in (q, k, v, out, g, lse, delta, dq_acc, dk_acc, dq, dk_,
                                              dv_)),
          b, n, dk, dv, _strides(q, k, v, out, g, dq, dk_, dv_))
    flash_attention_backward.launches += 1
    return dq, dk_, dv_


def reset_counts() -> None:
    """Sets flash_attention's launch, route and copy counts and
    flash_attention_backward's launch count to 0."""
    flash_attention.launches = 0
    flash_attention.routes = dict.fromkeys(ROUTES, 0)
    flash_attention.copied_bytes = 0
    flash_attention_backward.launches = 0


reset_counts()


def _bmm_like(like: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the layout of `like`'s gradient: channel-major computed as
    (bᵀ aᵀ)ᵀ."""
    if _gradient_channel_major(like):
        return torch.bmm(b.transpose(1, 2), a.transpose(1, 2)).transpose(1, 2)
    return torch.bmm(a, b)


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       g: torch.Tensor):
    """(dq, dk, dv) of reference_attention at (q, k, v) for the output
    gradient g, recomputing the softmax rather than saving it: the plain
    counterpart of the JAX package's `_pallas_attention_bwd`. Products in f32
    (f64 for f64 inputs) with torch.bmm on any strides; each gradient has its
    input's dtype and, where that input is channel-major, its layout."""
    ct = _compute_dtype(q)
    qc, kc, vc, gc = q.to(ct), k.to(ct), v.to(ct), g.to(ct)
    attn = torch.softmax(torch.bmm(qc, kc.transpose(1, 2)), dim=-1)  # (B, N, N)
    dv = _bmm_like(v, attn.transpose(1, 2), gc)
    ds = torch.bmm(gc, vc.transpose(1, 2))                           # dp
    ds.sub_((ds * attn).sum(dim=-1, keepdim=True)).mul_(attn)        # in place: one N x N less
    dq = _bmm_like(q, ds, kc)
    dk = _bmm_like(k, ds.transpose(1, 2), qc)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class SpatialAttention(torch.autograd.Function):
    """softmax(q kᵀ) v: on a CPU tensor the plain version and
    `attention_backward` (the forward saves q, k and v); on a CUDA tensor
    the forward kernel and the backward kernel (`flash_attention_backward`).
    Where a gradient is needed the CUDA forward also has the kernel write
    each row's log-sum-exp and one-hot flag (reference_lse), and saves them
    with q, k, v and the output; without
    one it writes and saves nothing more. Under a bf16 autocast the plain
    version computes as the bf16 kernel does: bf16 operands, f32 scores and
    sums, P rounded to bf16."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v)
            with torch.autocast("cpu", enabled=False):  # the kernels' arithmetic
                return reference_attention(q, k, v)
        b, n, dv = v.shape
        out = torch.empty((b, dv, n), dtype=v.dtype, device=v.device).transpose(1, 2)
        if not any(ctx.needs_input_grad):
            return flash_attention(q, k, v, out=out)
        lse = torch.empty((2, b, n), dtype=torch.float32, device=v.device)
        flash_attention(q, k, v, out=out, lse=lse)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    @once_differentiable  # attention_backward works in place on its N x N buffers
    def backward(ctx, g: torch.Tensor):
        saved = ctx.saved_tensors
        if len(saved) == 3:  # the CPU's plain forward
            return attention_backward(*saved, g)
        return flash_attention_backward(*saved, g)


@dataclasses.dataclass(frozen=True)
class RingRouting:
    """The ring (context-parallel) attention handle, threaded through a
    model's constructor down to its attention blocks (bcp.ComposeNet(ring=)):
    there is no global routing state. When `mesh` has >= 2 ranks on `axis`
    and the position axis N >= min_n divides by their number,
    spatial_self_attention runs the ring over them (the JAX rule)."""

    mesh: Any = None
    axis: str = "model"
    min_n: int = 1024

    def active(self, n: int) -> bool:
        """Whether a position axis of size n routes through the ring."""
        if self.mesh is None or self.axis not in (self.mesh.mesh_dim_names or ()):
            return False
        n_dev = self.mesh.size(self.mesh.mesh_dim_names.index(self.axis))
        return n_dev >= 2 and n >= self.min_n and n % n_dev == 0


def spatial_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           ring: Optional[RingRouting] = None) -> torch.Tensor:
    """Unscaled softmax attention over flattened spatial (or point) positions,
    differentiable through `SpatialAttention`.

    q, k: (B, N, Dk); v: (B, N, Dv), each position-major or channel-major.
    Returns (B, N, Dv). A CPU tensor takes the plain version; a CUDA tensor
    takes the kernel, which writes a channel-major result: the (B, N, Dv)
    transpose view of a contiguous (B, Dv, N). With a `ring` active for N,
    the ring over its mesh axis runs instead (every rank of the axis holds
    q, k and v whole) and the result is position-major."""
    if ring is not None and ring.active(q.shape[1]):
        from vaeplay_torch.parallel.ring_attention import replicated_ring_attention

        return replicated_ring_attention(q, k, v, ring.mesh, ring.axis)
    return SpatialAttention.apply(q, k, v)
