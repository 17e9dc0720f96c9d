"""Plain PyTorch references of the benchmarked models, one module per model.

They import nothing of `vaeplay_torch`, of JAX or of the JAX package, and
take nothing the port made: weights, batches and noise are made again here
from the run's seed. Each module offers `param_specs(cfg)`, the weights'
names, shapes and init bounds (the port's state_dict keys), and for its
cells `train(...)` and/or `infer(...)`, at a precision the caller picks
(common.PRECISIONS).
"""
