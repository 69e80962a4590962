"""Ops of the port: flash attention and paged attention (CUDA kernels and
their plain PyTorch versions), the attention dispatch of the models, and
per-row sampling."""
