"""Pairwise gravity and acc + jerk (plain PyTorch and the CUDA kernels),
collisions, the fused rollout kernel, the tree, PM and P3M solvers (P3M's
short range a CUDA kernel), and conservation diagnostics."""
