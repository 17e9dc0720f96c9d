"""Spatial / point-set self-attention.

Port of vaeplay_tpu/ops/attention.py. Semantics (the reference's, exactly):

  attn[b, i, j] = softmax_j(q[b, i, :] . k[b, j, :])   (NO 1/sqrt(d) scaling)
  out[b, i, :]  = sum_j attn[b, i, j] * v[b, j, :]

`spatial_self_attention` sends a CPU tensor to the plain version
`reference_attention` and a CUDA tensor to the hand-written kernel
(`csrc/flash_attention.cu`, through `flash_attention`), for every N. There is
no fallback: the kernel launches or the call raises.
"""

import ctypes

import torch

from vaeplay_torch.ops import _build

MAX_DK = 128  # the kernel's limit (MAX_DK in csrc/flash_attention.cu)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version: (B, N, Dk), (B, N, Dk), (B, N, Dv) -> (B, N, Dv).
    Products and softmax in f32; the result has v's dtype."""
    energy = torch.bmm(q.float(), k.float().transpose(1, 2))
    attn = torch.softmax(energy, dim=-1)
    return torch.bmm(attn, v.float()).to(v.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention: {name} is on {t.device}, not a CUDA device")
        if t.dim() != 3:
            raise ValueError(f"flash_attention: {name} must be (B, N, D), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("flash_attention: q, k, v must share one dtype and device")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} is not float32 or bfloat16")
    b, n, dk = q.shape
    if k.shape != q.shape or v.shape[:2] != (b, n):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if not (0 < dk <= MAX_DK) or n == 0 or v.shape[2] == 0 or not (0 < b <= 65535):
        raise ValueError(f"flash_attention: needs 0 < Dk <= {MAX_DK}, N > 0, Dv > 0 and "
                         f"0 < B <= 65535; got q {tuple(q.shape)}, v {tuple(v.shape)}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise RuntimeError("flash_attention: the CUDA kernel has no backward yet; "
                           "run it under torch.no_grad()")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream. CUDA tensors only;
    raises on anything the kernel does not take. `flash_attention.launches`
    counts the launches."""
    _check(q, k, v)
    b, n, dk = q.shape
    dv = v.shape[2]
    lib = _build.load("flash_attention")
    out = torch.empty((b, n, dv), dtype=v.dtype, device=v.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, n, dk, dv, _DTYPES[q.dtype], ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def spatial_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Unscaled softmax attention over flattened spatial (or point) positions.

    q, k: (B, N, Dk); v: (B, N, Dv). Returns (B, N, Dv). A CPU tensor takes
    the plain version, a CUDA tensor the kernel."""
    if q.device.type == "cpu":
        return reference_attention(q, k, v)
    return flash_attention(q, k, v)
