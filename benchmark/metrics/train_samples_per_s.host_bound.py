"""train_samples_per_s for a cell whose loop is bound by the host: the same
rate, training samples completed in the window over the window, under a
bound of its own, since such runs spread by the host's speed from process
to process. Host clock."""

from benchmark.core.readers import rate as read  # noqa: F401
