"""PyTorch + CUDA port of the Archipelago data plane, for NVIDIA Hopper.

A second package beside the JAX reference ``repro``; it imports ``torch``
and numpy, never ``jax`` and nothing of ``repro``.  Its entry points run on
the card unless the caller names another device (``device="cpu"`` runs the
plain PyTorch versions of the kernels).  See README.md, "The PyTorch port".
"""
