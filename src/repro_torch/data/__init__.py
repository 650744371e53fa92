"""Synthetic weather data (numpy; the port's copy of ``repro/data``)."""
