"""Benchmarks of the port on the card: counterparts of the JAX package's
``benchmarks/`` scripts."""
