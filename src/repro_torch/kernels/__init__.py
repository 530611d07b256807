"""Hand-written CUDA kernels for the fused int8 ring, their build, and their plain PyTorch versions."""
