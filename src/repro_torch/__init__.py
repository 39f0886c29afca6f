"""DIFET on PyTorch and CUDA: the paper's tile map/reduce with hand-written
Hopper kernels for its stencil hot spots.

Mirrors the layout of the JAX package ``repro`` (``configs/``, ``data/``,
``core/``, ``kernels/``) so each module has an obvious counterpart, but
imports nothing from it and never imports ``jax``.
"""
