"""Fused GFDM kernels and the detection front end (CUDA C++ for Hopper),
each with its plain torch version."""
