"""PyTorch/CUDA port of the shuffle-synthesis pipeline.

The stencil DSL is lowered to PTX, emulated symbolically and searched
for shuffle pairs exactly as in the JAX package (``repro``), whose
middle-end modules are copied here under the same names; the stencil
kernel then runs on an NVIDIA Hopper card as hand-written CUDA that
really issues ``__shfl_sync``.  Nothing here imports ``jax`` or
``repro``.
"""
