"""Tensor ops of the port: attention and the hand-written kernels."""
