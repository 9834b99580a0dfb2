"""Models of the port (FM so far)."""
