"""Core helpers of the port: device resolution and the training config."""
