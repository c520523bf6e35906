"""Tensor operations: normalizations, consensus, liquid alpha, and the
CUDA kernels with their plain PyTorch versions."""
