"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

``block_matmul`` (``csrc/block_matmul.cu``) replaces the Pallas kernel of
``repro/kernels/block_matmul.py``; ``wx``, ``ring`` and ``cannon``
(``csrc/{wx,ring,cannon}.cu``) those of ``repro/kernels/fused_ring.py``;
``ssd_chunk`` (``csrc/ssd_chunk.cu``) that of ``repro/kernels/ssd_chunk.py``;
``ref`` holds the plain versions; ``ops`` the entry points the model calls.
"""
