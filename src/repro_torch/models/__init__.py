"""Models of the port (the mixer family so far)."""
