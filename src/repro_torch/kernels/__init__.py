"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

``block_matmul`` (``csrc/block_matmul.cu``) replaces the Pallas kernel of
``repro/kernels/block_matmul.py``; ``ref`` holds the plain versions; ``ops``
the entry points the model calls.
"""
