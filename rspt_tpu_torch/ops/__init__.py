"""Exact int32 tensor ops (torch_ops) and the hand-written CUDA kernels
(cuda_kernels, sources in csrc/, built by _build)."""
