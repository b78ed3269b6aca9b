"""Pairwise gravity and acc + jerk (plain PyTorch and the CUDA kernels),
collisions, the fused rollout kernel, and conservation diagnostics."""
