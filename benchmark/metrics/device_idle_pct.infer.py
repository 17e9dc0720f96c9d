"""The share of the traced window of closed-loop batches in which no
operation ran on the card."""

from benchmark.core.readers import idle_pct as read  # noqa: F401
