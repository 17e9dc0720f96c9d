"""The attention forward kernels' share of their roofline in a training
step: the one-pass bound of the reference's attention calls (2 B N² (Dk +
Dv) at the operand type's peak, or the bytes of q, k, v and the output at
3.35 TB/s) over the device time of the flash_attention kernels."""

from benchmark.core.readers import attention_roofline_pct as read  # noqa: F401
