"""Model configurations (the port's copy of ``repro/configs``)."""
