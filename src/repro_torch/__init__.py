"""ResidualPlanner(+) in PyTorch with hand-written CUDA kernels for Hopper.

A port of the JAX package ``repro`` (the reference, left unchanged beside it).
It imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``.  Entry
points run on CUDA unless the caller passes ``device="cpu"``; with no CUDA
device and no explicit CPU request they raise.
"""
