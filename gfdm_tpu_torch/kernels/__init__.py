"""Fused GFDM kernels, the detection front end, the link's GEMM chain and
the Viterbi decoder (CUDA C++ for Hopper), each with its plain torch
version."""
