"""Numerics, observers and the hand-written CUDA kernels."""
