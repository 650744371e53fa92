"""PyTorch/CUDA port of the Jigsaw WeatherMixer system.

A package beside the JAX reference (``repro``), with the same layout:
``configs``, ``core``, ``kernels`` (hand-written Hopper kernels under
``kernels/csrc`` and their plain PyTorch versions), ``models``, ``serve``,
``data``, ``telemetry``, ``launch``.  It imports torch and numpy, never jax
and nothing of ``repro``.  ``convert`` carries weights between the two
packages through numpy.
"""
