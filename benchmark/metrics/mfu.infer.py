"""The forward's model FLOPs (counted on the plain reference) over the
traced window of closed-loop batches, as a share of the peak of the cell's
compute type."""

from benchmark.core.readers import mfu_pct as read  # noqa: F401
