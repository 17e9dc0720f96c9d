"""The share of the traced training window in which no operation ran on
the card: 1 - the union of its activities' intervals over the window."""

from benchmark.core.readers import idle_pct as read  # noqa: F401
