"""Tensor ops of the port: activations, losses, metrics and the
hand-written kernels."""
