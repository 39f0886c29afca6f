"""Host mesh construction (port of ``repro/launch/mesh.py``).

``make_host_mesh`` is a function, so that importing this module touches no
device.  The reference's ``make_production_mesh`` (16 x 16 chips a pod)
belongs to the LM substrate and is not ported here.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import Mesh


def make_host_mesh(device=None) -> Mesh:
    """A ``("data", "model")`` mesh of every card this host has x 1: the
    mesh of the launchers.  ``device="cpu"`` asks for the one CPU device
    (a 1 x 1 mesh); otherwise the host needs a card.  A device with an
    index (``cuda:1``) names one card, not the host: it raises."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cpu":
            return Mesh(["cpu"], ("data", "model"))
        if dev.index is not None:
            raise ValueError(f"make_host_mesh takes every card of the host; "
                             f"{dev} names one (run without a mesh there)")
    if not torch.cuda.is_available():
        raise RuntimeError("make_host_mesh: no CUDA card on this host; pass "
                           "device='cpu' for a CPU mesh")
    return Mesh([f"cuda:{i}" for i in range(torch.cuda.device_count())],
                ("data", "model"))
