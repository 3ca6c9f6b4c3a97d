"""Layers with the JAX package's numerics and the hand-written kernels."""
