"""The whole training step's model FLOPs (matmuls and convolutions of the
forward and backward passes the step's algorithm needs, counted on the
plain reference, no recompute) over the traced window, as a share of the
peak of the cell's compute type (bf16 989, f32 on TF32 495 TFLOP/s)."""

from benchmark.core.readers import mfu_pct as read  # noqa: F401
