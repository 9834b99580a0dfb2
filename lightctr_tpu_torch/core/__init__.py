"""Core helpers of the port: device resolution."""
