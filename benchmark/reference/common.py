"""What the references share: weights from a seed, the precision they
compute in, plain Adam, plain attention, and the per-leaf records that the
comparison reads.

Precisions:
  f32   float32 with TF32 off for both cuDNN convolutions and matmuls: the
        reference proper;
  f32_default
        float32 under PyTorch's default flags, as a float32 cell's program
        runs: cuDNN convolutions may take TF32, matmuls do not (a witness);
  bf16  bf16 autocast, f32 state: the control of a float32 cell (whose
        convolutions may take TF32, PyTorch's default);
  fp8   bf16 autocast with every convolution's, linear layer's and batched
        product's operands rounded to float8 e4m3 (one scale a tensor, the
        rounding passed straight through in the backward): the control of a
        bfloat16 cell.
"""

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

PRECISIONS = ("f32", "f32_default", "bf16", "fp8")
# the control of a cell: the nearest precision below the cell's own
CONTROL = {"float32": "bf16", "bfloat16": "fp8"}
FP8_MAX = 448.0  # largest finite float8 e4m3fn


@dataclasses.dataclass
class Spec:
    """One weight: its state_dict key, shape and init bound (U(-bound,
    bound); 0 gives zeros)."""

    name: str
    shape: Tuple[int, ...]
    bound: float


def conv_spec(name: str, c_out: int, c_in: int, k: int, bias: bool = True,
              transposed: bool = False) -> List[Spec]:
    """A conv weight (out, in, k, k), or a transposed one (in, out, k, k),
    Kaiming-uniform over fan_in = shape[1] k², and its bias U(±1/sqrt(fan_in))."""
    shape = (c_in, c_out, k, k) if transposed else (c_out, c_in, k, k)
    fan_in = shape[1] * k * k
    out = [Spec(name + "weight", shape, math.sqrt(6.0 / fan_in))]
    if bias:
        out.append(Spec(name + "bias", (c_out,), 1.0 / math.sqrt(fan_in)))
    return out


def linear_spec(name: str, n_out: int, n_in: int) -> List[Spec]:
    """A linear weight (out, in) U(±1/sqrt(in)) (Kaiming-uniform, a = sqrt(5))
    and its bias likewise."""
    b = 1.0 / math.sqrt(n_in)
    return [Spec(name + "weight", (n_out, n_in), b), Spec(name + "bias", (n_out,), b)]


def make_weights(specs: Sequence[Spec], seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight of `specs` from `seed`, f32 on `device`: one uniform draw
    of all of them from a generator on the device, then each slice scaled.
    The tensors are views of one buffer."""
    total = sum(math.prod(s.shape) for s in specs)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(total, device=device).uniform_(-1.0, 1.0, generator=gen)
    out, offset = {}, 0
    for s in specs:
        n = math.prod(s.shape)
        t = flat[offset:offset + n].view(s.shape)
        out[s.name] = t.mul_(s.bound) if s.bound > 0 else t.zero_()
        offset += n
    return out


def nudged(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every weight moved one ulp up: a start that differs from the
    reference's by round-off alone (a witness, not a fault)."""
    return {k: torch.nextafter(v, torch.full_like(v, math.inf)) for k, v in weights.items()}


def leaves(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Trainable copies of `weights`."""
    return {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}


class _RoundFP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = FP8_MAX / x.detach().abs().amax().float().clamp(min=1e-30)
        return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


class Ops:
    """The reference's products at one precision. `attention_shapes` lists
    the (B, N, Dk, Dv) of every attention call, in order."""

    def __init__(self, precision: str):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.precision = precision
        self.attention_shapes: List[Tuple[int, int, int, int]] = []

    def _q(self, *ts):
        if self.precision != "fp8":
            return ts
        return tuple(None if t is None else _RoundFP8.apply(t) for t in ts)

    def conv2d(self, x, w, b, stride: int = 1, padding: int = 0):
        x, w = self._q(x, w)
        return F.conv2d(x, w, b, stride, padding)

    def conv_transpose2d(self, x, w, b, stride: int = 2, padding: int = 1):
        x, w = self._q(x, w)
        return F.conv_transpose2d(x, w, b, stride, padding)

    def linear(self, x, w, b):
        x, w = self._q(x, w)
        return F.linear(x, w, b)

    def attention(self, q, k, v):
        """softmax(q kᵀ) v over (B, N, C) with no 1/sqrt(d) scale."""
        self.attention_shapes.append((q.shape[0], q.shape[1], q.shape[2], v.shape[2]))
        q, k = self._q(q, k)
        attn = torch.softmax(torch.bmm(q, k.transpose(1, 2)), dim=-1)
        attn, v = self._q(attn, v)
        return torch.bmm(attn, v)

    @contextlib.contextmanager
    def context(self, device):
        """Autocast for bf16 and fp8; TF32 off for f32, PyTorch's default
        flags for f32_default (restored after)."""
        if self.precision in ("f32", "f32_default"):
            saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
            torch.backends.cudnn.allow_tf32 = self.precision == "f32_default"
            torch.backends.cuda.matmul.allow_tf32 = False
            try:
                yield
            finally:
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
        else:
            with torch.autocast(torch.device(device).type, dtype=torch.bfloat16):
                yield


def activation(x, kind: Optional[str], slope: float = 0.02):
    if kind is None:
        return x
    if kind == "relu":
        return F.relu(x)
    if kind == "lrelu":
        return F.leaky_relu(x, slope)
    raise ValueError(kind)


class Adam:
    """torch.optim.Adam's update (no weight decay, no amsgrad), written out:
    m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g², p -= lr / (1 - b1^t) m /
    (sqrt(v) / sqrt(1 - b2^t) + eps), in f32."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.betas, self.eps, self.t = params, lr, betas, eps, 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        b1, b2 = self.betas
        self.t += 1
        c1, c2 = 1 - b1 ** self.t, math.sqrt(1 - b2 ** self.t)
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            p.addcdiv_(self.m[k], self.v[k].sqrt().div_(c2).add_(self.eps), value=-self.lr / c1)


def grads_of(loss: torch.Tensor, params: Dict[str, torch.Tensor], **kw) -> Dict[str, torch.Tensor]:
    """d loss / d params, zeros for the parameters the loss does not reach."""
    names = list(params)
    gs = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True, **kw)
    return {k: torch.zeros_like(params[k]) if g is None else g for k, g in zip(names, gs)}


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each tensor's f32 norm, read back in one copy."""
    names = list(tensors)
    if not names:
        return {}
    vals = torch.stack([tensors[k].detach().float().norm() for k in names]).cpu().tolist()
    return dict(zip(names, vals))


@dataclasses.dataclass
class TrainRecord:
    """What the comparison of a training cell reads, from the program or
    from a reference: each step's losses, every leaf's first gradient norm
    (as its optimizer got it), the norm of its change after the steps, and
    the first step's model outputs. A reference adds the gradient norms of
    every optimizer step, in order (one dict of the leaves it steps each),
    the model FLOPs of its first step, the shapes of its attention calls a
    step, the losses that precede a step's first update (`pre_update`) and,
    given another run's first gradients, each leaf's norm of the difference
    (`first_grad_diff`) and the share of its elements whose sign differs
    (`first_grad_flips`). `teacher` holds, per step, answers of the run's own
    that a reference continues from (BP: stage 1's ellipse parameters, which
    stage 2 samples at)."""

    losses: List[Dict[str, float]]
    first_grad: Dict[str, float]
    update: Dict[str, float]
    first_outputs: Optional[Dict[str, torch.Tensor]] = None
    grad_norms: Optional[List[Dict[str, float]]] = None
    flops_per_step: Optional[float] = None
    attention_shapes: Sequence[Tuple[int, int, int, int]] = ()
    teacher: Optional[List[torch.Tensor]] = None
    pre_update: Sequence[str] = ()
    first_grad_tensors: Optional[Dict[str, torch.Tensor]] = None
    first_grad_diff: Optional[Dict[str, float]] = None
    first_grad_flips: Optional[Dict[str, float]] = None


def flop_counter():
    """A context counting model FLOPs (matmuls and convolutions, forward
    and backward) of the work run inside it: `.get_total_flops()`."""
    from torch.utils.flop_counter import FlopCounterMode

    return FlopCounterMode(display=False)


def swap_last_row(t: torch.Tensor) -> torch.Tensor:
    """t with its last row replaced by its first: one sample's answer
    altered where it is produced (a planted fault)."""
    return torch.cat([t[:-1], t[:1]])


def run_train(step_fn, params: Dict[str, torch.Tensor], steps: int, ops: Ops,
              pre_update: Sequence[str] = (), against: Optional[Dict[str, torch.Tensor]] = None,
              keep_first_grads: bool = False) -> TrainRecord:
    """Drive a reference training step `steps` times and record it.

    step_fn(k, descend) runs step k, calling descend(optimizer, grads) for
    each optimizer step in order, and returns (losses {name: 0-d tensor},
    answer, outputs): the answer a later reference continues from (or None)
    and the step's model outputs {name: tensor}. The first step runs under
    the FLOP counter. `pre_update` names the losses a step computes before
    its first optimizer update; `against`, another run's first gradient of
    each leaf, gives first_grad_diff, the norm of each leaf's difference from
    it; `keep_first_grads` keeps this run's first gradients on the host for
    a later run to be compared against."""
    theta0 = {k: p.detach().clone() for k, p in params.items()}
    losses, grad_norms, flops, shapes, teacher, outputs = [], [], None, (), [], None
    diff, flips = (None, None) if against is None else ({}, {})
    kept = {} if keep_first_grads else None
    for k in range(steps):

        def descend(opt: Adam, grads: Dict[str, torch.Tensor]) -> None:
            grad_norms.append(norms(grads))
            if diff is not None and k == 0:
                new = [n for n in grads if n not in diff]
                other = {n: against[n].to(grads[n].device) for n in new}
                diff.update(norms({n: grads[n] - other[n] for n in new}))
                flips.update(norms({n: (grads[n] * other[n] < 0).sum() / grads[n].numel()
                                    for n in new}))
            if kept is not None and k == 0:
                kept.update({n: g.detach().to("cpu", copy=True) for n, g in grads.items()
                             if n not in kept})
            opt.step(grads)

        n_before = len(ops.attention_shapes)
        counter = flop_counter() if k == 0 else contextlib.nullcontext()
        with counter:
            step_losses, answer, step_outputs = step_fn(k, descend)
        if k == 0:
            flops = counter.get_total_flops()
            shapes = tuple(ops.attention_shapes[n_before:])
            outputs = {n: v.detach().float() for n, v in step_outputs.items()}
            first = {}
            for g in grad_norms:
                for name, v in g.items():
                    first.setdefault(name, v)
        losses.append({n: float(v) for n, v in step_losses.items()})
        teacher.append(answer)
    update = norms({k: params[k].detach() - theta0[k] for k in params})
    return TrainRecord(losses, first, update, outputs, grad_norms, flops, shapes,
                       teacher if any(t is not None for t in teacher) else None,
                       pre_update=tuple(pre_update), first_grad_tensors=kept,
                       first_grad_diff=diff, first_grad_flips=flips)
