"""Compute ops: covariances, the raw voxel grid, per-correspondence math and
the CUDA kernels with their plain PyTorch versions."""
