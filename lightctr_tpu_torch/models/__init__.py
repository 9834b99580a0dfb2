"""Models of the port (FM so far) and the CTR trainers."""
