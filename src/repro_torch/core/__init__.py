"""Linear-layer API and precision policies (scheme="none" so far)."""
