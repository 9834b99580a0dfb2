"""Tensor ops of the port: activations and the hand-written kernels."""
