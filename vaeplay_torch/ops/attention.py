"""Spatial / point-set self-attention.

Port of vaeplay_tpu/ops/attention.py. Semantics (the reference's, exactly):

  attn[b, i, j] = softmax_j(q[b, i, :] . k[b, j, :])   (NO 1/sqrt(d) scaling)
  out[b, i, :]  = sum_j attn[b, i, j] * v[b, j, :]

`spatial_self_attention` runs through the `SpatialAttention` autograd
Function, whose forward sends a CPU tensor to the plain version
`reference_attention` and a CUDA tensor to a hand-written kernel (through
`flash_attention`): f32 operands to `csrc/flash_attention.cu` (3xTF32), bf16
operands to `csrc/flash_attention_bf16.cu` (bf16 wgmma, the TPU kernel's
default arithmetic), for every N. There is no fallback: the kernel launches
or the call raises. Its backward, on either device, is `attention_backward`:
the JAX package's recompute VJP (`_pallas_attention_bwd`) as plain f32
batched matrix products.

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
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("flash_attention: the kernel wrapper records no gradient; call "
                           "spatial_self_attention, whose autograd Function has the backward")


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


_FUNCTIONS = {}  # dtype -> its kernel's C function, bound at first use
_STRIDES = {}  # the 12 strides of a call -> their ctypes array, built once


def _kernel(dtype: torch.dtype):
    fn = _FUNCTIONS.get(dtype)
    if fn is None:
        library, function = _KERNELS[dtype]
        fn = _FUNCTIONS[dtype] = getattr(_build.load(library), function)
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the kernel of q's dtype on PyTorch's current stream and return
    `out` (by default a new contiguous (B, N, Dv)), written by the kernel in
    that dtype. CUDA tensors only; raises on anything the kernels do not
    take. `flash_attention.launches` counts the launches, `.routes` them by
    dtype and route (ROUTES), `.copied_bytes` the bytes of operand copies;
    `reset_counts()` sets all three to 0."""
    _check(q, k, v)
    b, n, dk = q.shape
    dv = v.shape[2]
    if out is None:
        out = torch.empty((b, n, dv), dtype=v.dtype, device=v.device)
    else:
        _check_out(out, v)
    k_in, v_in, route = kernel_operands(k, v)
    fn = _kernel(q.dtype)
    key = q.stride() + k_in.stride() + v_in.stride() + out.stride()
    strides = _STRIDES.get(key)
    if strides is None:
        strides = _STRIDES[key] = (ctypes.c_longlong * 12)(*key)
    index = q.device.index
    # the current stream's handle (torch.cuda.current_stream(index).cuda_stream
    # without building a Stream object: a few microseconds a call)
    args = (q.data_ptr(), k_in.data_ptr(), v_in.data_ptr(), out.data_ptr(), b, n, dk, dv, strides,
            int(route == "direct"), torch._C._cuda_getCurrentRawStream(index))
    if index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.routes[f"{str(q.dtype)[6:]}/{route}"] += 1
    return out


def reset_counts() -> None:
    """Sets flash_attention's launch, route and copy counts to 0."""
    flash_attention.launches = 0
    flash_attention.routes = dict.fromkeys(ROUTES, 0)
    flash_attention.copied_bytes = 0


reset_counts()


def _bmm_like(like: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the layout of `like`: where `like` is channel-major, computed
    as (bᵀ aᵀ)ᵀ, so the result is the transpose view of a contiguous
    (B, C, N) and the NCHW convolution behind it takes its gradient with no
    copy."""
    if like.stride(2) != 1 and like.stride(1) == 1:
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
    """softmax(q kᵀ) v with the kernel's forward on a CUDA tensor, the plain
    version on a CPU tensor, and `attention_backward` on both. The forward
    saves only q, k and v. Under a bf16 autocast the plain version computes
    as the bf16 kernel does: bf16 operands, f32 scores and sums, P rounded
    to bf16."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            with torch.autocast("cpu", enabled=False):  # the kernels' arithmetic
                return reference_attention(q, k, v)
        b, n, dv = v.shape
        out = torch.empty((b, dv, n), dtype=v.dtype, device=v.device).transpose(1, 2)
        return flash_attention(q, k, v, out=out)

    @staticmethod
    @once_differentiable  # attention_backward works in place on its N x N buffers
    def backward(ctx, g: torch.Tensor):
        return attention_backward(*ctx.saved_tensors, g)


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
