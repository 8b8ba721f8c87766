"""PyTorch/CUDA port of the ``repro`` serving system for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports neither it
nor JAX. Entry points run on ``cuda`` unless the caller asks for the CPU.
"""
