"""Mesh construction (port of ``repro/launch/mesh.py``).

Every mesh here is made by a function, so that importing this module
touches no device and joins no process group.

* `make_host_mesh`: the tile path's ``("data", "model")`` mesh of every
  card of the host x 1 (a `Mesh` of devices, one controller).
* `make_lm_host_mesh`: the LM substrate's ``(world, 1)`` mesh over the
  ranks ``torchrun`` started (an `LMMesh`; NCCL on the cards, gloo on the
  CPU).
* `make_production_mesh`: the reference's ``(16, 16)`` ``("data",
  "model")`` pod, or ``(2, 16, 16)`` ``("pod", "data", "model")``, over a
  fake process group of 256 or 512 ranks whose collectives move nothing.
  This process is rank 0, and its view is the per-device program: what the
  reference's ``--xla_force_host_platform_device_count=512`` buys.
"""
from __future__ import annotations

import os

import torch

from repro_torch.distributed.sharding import LMMesh, Mesh


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


def _device_mesh(device_type: str, shape, names) -> LMMesh:
    from torch.distributed.device_mesh import init_device_mesh
    return LMMesh.from_device_mesh(
        init_device_mesh(device_type, tuple(shape), mesh_dim_names=names))


def make_fake_mesh(shape, axis_names) -> LMMesh:
    """A mesh of ``shape`` over a fake process group (collectives move
    nothing), this process its rank 0.  Raises if this process already has
    a process group (`release_mesh` ends it)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("make_fake_mesh: this process already has a "
                           "process group")
    world = 1
    for s in shape:
        world *= s
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    # a CUDA mesh where torch is built with CUDA (built directly, it
    # touches no card), else a CPU one: the device of the traced fake tensors
    from torch.distributed.device_mesh import DeviceMesh
    kind = "cuda" if torch.backends.cuda.is_built() else "cpu"
    return LMMesh.from_device_mesh(DeviceMesh(
        kind, torch.arange(world).view(tuple(shape)),
        mesh_dim_names=tuple(axis_names)))


def make_production_mesh(*, multi_pod: bool = False) -> LMMesh:
    """16 x 16 chips a pod (``data`` x ``model``); 2 pods stack a ``pod``
    axis: `make_fake_mesh` of 256 (512) ranks."""
    if multi_pod:
        return make_fake_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_fake_mesh((16, 16), ("data", "model"))


def make_lm_host_mesh(device=None) -> LMMesh:
    """A ``("data", "model")`` mesh of (world, 1) over the ranks of this
    job: the group already joined, or the one ``torchrun``'s environment
    describes (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ...), joined here
    with NCCL on the cards and gloo when ``device`` is the CPU.  On the
    cards each rank takes card ``LOCAL_RANK``."""
    import torch.distributed as dist
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("make_lm_host_mesh: no CUDA card on this "
                               "host; pass device='cpu' for gloo")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if not dist.is_initialized():
        dist.init_process_group("gloo" if cpu else "nccl")
    return _device_mesh("cpu" if cpu else "cuda",
                        (dist.get_world_size(), 1), ("data", "model"))


def release_mesh() -> None:
    """End this process's process group (the fake one of
    `make_production_mesh`, or a host mesh's)."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
