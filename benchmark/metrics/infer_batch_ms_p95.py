"""95th percentile of every batch's latency in the window: the host clock
from the call of the predict entry to the synchronize after it, the copy
of the images to the card included."""

from benchmark.core.readers import p95_ms as read  # noqa: F401
