"""DIFET on PyTorch and CUDA: the paper's tile map/reduce with hand-written
Hopper kernels for its stencil hot spots, and the LM substrate's model
library and serving path.

Mirrors the layout of the JAX package ``repro`` (``configs/``, ``data/``,
``core/``, ``kernels/``, ``distributed/``, ``models/``, ``serve/``,
``obs/``, ``launch/``) so each module has an obvious counterpart, but
imports nothing from it and never imports ``jax``.
"""
