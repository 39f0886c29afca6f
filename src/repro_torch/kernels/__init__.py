"""Hand-written CUDA kernels (Hopper, sm_90a) for DIFET's stencil hot spots,
each beside its plain PyTorch twin (``ref.py``).

``harris``, ``fastscore``, ``blur`` and ``scalespace`` replace the Pallas
kernels of the same names in ``repro/kernels``.  Sources live in ``csrc/``
and are compiled by ``build.py`` at first use.
"""
