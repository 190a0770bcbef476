"""Tensor ops of the port: attention, LayerNorm, int8 weight
quantization, and the loader of the hand-written CUDA kernels
(:mod:`.kernels`)."""
