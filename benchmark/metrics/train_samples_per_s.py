"""Training samples completed in the window over the window: every step's
batch, from the first step's call to a synchronize after the last. Host
clock."""

from benchmark.core.readers import rate as read  # noqa: F401
