"""The attention forward kernels' share of their roofline in a batch, as
attn_fwd_roofline.train reads it."""

from benchmark.core.readers import attention_roofline_pct as read  # noqa: F401
