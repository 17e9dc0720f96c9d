"""attn_fwd_roofline.train in a cell that reports
train_samples_per_s.host_bound."""

from benchmark.core.readers import attention_roofline_pct as read  # noqa: F401
