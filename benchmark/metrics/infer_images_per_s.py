"""Images of the batches completed in the window over the window. Host
clock."""

from benchmark.core.readers import rate as read  # noqa: F401
