"""Fused GFDM kernels (CUDA C++ for Hopper) with their plain torch versions."""
