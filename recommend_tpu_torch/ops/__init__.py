"""Attention, normalization and the hand-written CUDA kernels."""
