"""Fused GFDM kernels, the detection front end and the link's GEMM chain
(CUDA C++ for Hopper), each with its plain torch version."""
