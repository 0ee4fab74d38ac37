"""Operators (NumPy), planar primitives and the planar link as torch ops."""
