"""GADGET reproduction in PyTorch: elastic ring-all-reduce training with
hand-written CUDA kernels for the fused int8 ring, for an NVIDIA H100.

This package mirrors ``src/repro`` module for module and imports neither
JAX nor anything of ``repro``. Entry points run on ``device="cuda"``
unless the caller asks for ``"cpu"``.
"""
