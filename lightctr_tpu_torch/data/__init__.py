"""Host data plane of the port (batching so far)."""
