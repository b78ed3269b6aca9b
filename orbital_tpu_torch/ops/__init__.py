"""Pairwise gravity (plain PyTorch and the CUDA kernels), the fused
rollout kernel, and conservation diagnostics."""
