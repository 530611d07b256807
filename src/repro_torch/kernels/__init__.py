"""Hand-written CUDA kernels (the fused rings' hop kernels and flash attention), their build, and their plain PyTorch versions."""
