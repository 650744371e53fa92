"""Synthetic weather and token data (numpy; the port's copies of
``repro/data``) and the weather input pipeline."""
