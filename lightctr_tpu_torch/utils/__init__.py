"""Utilities of the port (trace annotation so far)."""
