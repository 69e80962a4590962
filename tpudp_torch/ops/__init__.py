"""Ops of the port: paged attention (CUDA kernels and their plain PyTorch
version) and per-row sampling."""
