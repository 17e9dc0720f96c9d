"""Peaks of one H100 SXM and the one-pass attention bound.

NVIDIA's data-sheet peaks (dense, no sparsity) at the card's full 700 W
power limit. A share of them is stated with the card's power limit beside
it. The attention bound counts the operations once, at the peak of the
operands' type: a kernel that computes f32 in several TF32 passes does so
by its own choice, so it is not credited for the extra passes.
"""

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}  # f32 operands: TF32, the fastest f32 rate
PEAK_BYTES_PER_S = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def attention_bound_s(shape, dtype: str) -> float:
    """Least seconds of one softmax(q kᵀ) v over (B, N, Dk, Dv): the larger
    of 2 B N² (Dk + Dv) operations at the peak of `dtype` and the bytes of
    q, k and v read once and the output written once at the memory rate."""
    b, n, dk, dv = shape
    flops = 2.0 * b * n * n * (dk + dv)
    nbytes = ITEMSIZE[dtype] * (2 * b * n * dk + 2 * b * n * dv)
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)
