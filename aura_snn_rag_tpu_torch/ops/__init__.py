"""Kernels of the port (`cuda/`): hand-written CUDA for Hopper, each beside
its plain PyTorch version."""
