"""PyTorch/CUDA port of vaeplay_tpu for NVIDIA Hopper GPUs.

The JAX package `vaeplay_tpu` is the reference; this package mirrors its
layout (ops/, core/, models/, data/, utils/, eval/, cli/) and imports
nothing of it, nor of JAX.
"""
