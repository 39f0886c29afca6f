"""The data mesh of the tile path: a batch split by rows over devices.

Port of the part of ``repro/distributed/sharding.py`` that the tile path
needs.  The reference runs one controller, ``jax.jit`` with the batch axis
sharded over a ``("data",)`` mesh; here the one controller is the calling
thread:

* a `Mesh` is an ordered tuple of torch devices with axis names (CUDA
  devices always carry their index; an entry may repeat, so that a mesh of
  ``("cpu",) * 4`` or of one card listed four times runs the split);
* `shard` cuts a batch into contiguous row slices, one per entry in mesh
  order, each staged straight to its entry's device (`split_rows`; it
  stands in for the reference's ``batch_pspec``);
* `MeshRunner` runs one piece of work per entry, each on its device and a
  CUDA stream of its own, issued from the calling thread one step of each
  entry in turn, and brings the pieces to the mesh's first device after
  that device's stream has waited for each;
* `one_device` turns a mesh of one entry into its device: one entry runs
  the one-device program, as the reference's ``_shard_batch`` sends a mesh
  of size 1 down its plain path.

The reference pads a batch to a multiple of the mesh size and crops the
pad afterwards (a sharding needs equal shards); the port splits unevenly
instead, so nothing is padded or cropped.  The parameter rules of the
reference's module (``resolve_spec``, ``pspec_for``, ``use_mesh``, ...)
belong to the LM substrate and are not ported here.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available on this host; build a CPU mesh "
                "(Mesh(['cpu'] * n)) to run the plain path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise ValueError(f"{dev}: this host has "
                             f"{torch.cuda.device_count()} CUDA device(s)")
    elif dev.type != "cpu":
        raise ValueError(f"a mesh runs on cpu or cuda devices, not {dev}")
    return dev


class Mesh:
    """An ordered tuple of devices with axis names.

    The first axis (``"data"``) runs over the devices; any further axis
    (``make_host_mesh``'s ``"model"``) has size 1.  Entries may repeat.
    All entries share one device type."""

    def __init__(self, devices: Iterable,
                 axis_names: Sequence[str] = ("data",)):
        self.devices = tuple(_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in self.devices}) != 1:
            raise ValueError(f"a mesh's devices share one type: "
                             f"{self.devices}")
        self.axis_names = tuple(axis_names)
        self.shape = {a: len(self.devices) if i == 0 else 1
                      for i, a in enumerate(self.axis_names)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def type(self) -> str:
        return self.devices[0].type

    def __len__(self) -> int:
        return len(self.devices)

    def __iter__(self):
        return iter(self.devices)

    def __getitem__(self, i) -> torch.device:
        return self.devices[i]

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.devices == other.devices
                and self.axis_names == other.axis_names)

    def __hash__(self) -> int:
        return hash((self.devices, self.axis_names))

    def __repr__(self) -> str:
        names = ", ".join(str(d) for d in self.devices)
        return f"Mesh(({names}), {self.axis_names})"


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Data-parallel mesh axes (pod-major on multi-pod meshes)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def data_mesh(n_devices: Optional[int] = None) -> Mesh:
    """A 1-D ``("data",)`` mesh over the first ``n_devices`` CUDA cards
    (all of them by default): the mesh of the extraction workload, whose
    only parallel axis is the tile batch.  Raises outside ``[1, cards]``,
    and on a host without a card (build ``Mesh(["cpu"] * n)`` to run on the
    CPU)."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("data_mesh: no CUDA card on this host; pass CPU "
                           "devices instead (Mesh(['cpu'] * n))")
    n = count if n_devices is None else int(n_devices)
    if not 1 <= n <= count:
        raise ValueError(f"n_devices={n} outside [1, {count}]")
    return Mesh([f"cuda:{i}" for i in range(n)], ("data",))


def split_rows(n: int, mesh: Mesh) -> List[Tuple[int, int]]:
    """Contiguous ``[lo, hi)`` row ranges, one per mesh entry in mesh
    order, covering ``[0, n)``: the first ``n % size`` entries take one row
    more than the others (an entry may get none)."""
    size = mesh.size
    base, extra = divmod(int(n), size)
    bounds = np.cumsum([0] + [base + (i < extra) for i in range(size)])
    return [(int(bounds[i]), int(bounds[i + 1])) for i in range(size)]


def one_device(mesh: Optional[Mesh], device=None):
    """``(mesh, device)`` for a job or a sweep given one or the other: a
    mesh of one entry becomes ``(None, its device)``, so that it runs the
    one-device code (``mesh=None``) on that device; a mesh of more entries
    (the same card listed twice included) stays.  Raises when both are
    given."""
    if mesh is not None and device is not None:
        raise ValueError("run on a device or a mesh, not both")
    if mesh is not None and mesh.size == 1:
        return None, mesh[0]
    return mesh, device


class Sharded:
    """A batch split by rows over a mesh: ``parts[i]`` holds entry i's
    contiguous rows on ``mesh[i]`` (`split_rows` of the whole)."""

    __slots__ = ("parts", "mesh")

    def __init__(self, parts: Sequence[torch.Tensor], mesh: Mesh):
        if len(parts) != mesh.size:
            raise ValueError(f"{len(parts)} parts for a mesh of {mesh.size}")
        self.parts = tuple(parts)
        self.mesh = mesh

    @property
    def shape(self) -> Tuple[int, ...]:
        return (sum(p.shape[0] for p in self.parts),) \
            + tuple(self.parts[0].shape[1:])

    def __len__(self) -> int:
        return self.shape[0]


def shard(x, mesh: Mesh, dtype: Optional[torch.dtype] = None) -> Sharded:
    """``x`` (a numpy array or a tensor on any device; a `Sharded` on
    ``mesh`` passes through) cut by `split_rows`, each slice copied straight
    to its entry's device: the whole batch is never staged on one card.
    A copy from another card runs on the calling thread's current streams,
    as any ``.to`` does."""
    if isinstance(x, Sharded):
        if x.mesh != mesh:
            raise ValueError(f"a batch sharded over {x.mesh}, not {mesh}")
        return x
    t = torch.as_tensor(x)
    if dtype is not None:
        t = t.to(dtype)
    return Sharded([t[lo:hi].to(dev).contiguous()
                    for dev, (lo, hi) in zip(mesh, split_rows(len(t), mesh))],
                   mesh)


class MeshRunner:
    """Runs one piece of work per mesh entry and brings the results to the
    mesh's first device.

    The calling thread issues every entry's work, one step of each entry
    in turn, so that no card waits while the host fills another's queue.
    On CUDA each entry works on a stream of its own on its card, which
    first waits for the calling thread's current stream there (the inputs
    were staged on it).  A failure on any entry is raised in the calling
    thread."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self._streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
                         for d in mesh]

    def _on(self, i: int):
        stream = self._streams[i]
        if stream is None:
            return contextlib.nullcontext()
        ctx = contextlib.ExitStack()
        ctx.enter_context(torch.cuda.device(self.mesh[i]))
        ctx.enter_context(torch.cuda.stream(stream))
        return ctx

    def run(self, work: Callable[[int], Iterable[Tuple[str, Dict]]],
            entries: Sequence[int]) -> List[Dict[str, Dict]]:
        """``work(i)`` yields ``(key, {name: tensor})`` steps for entry i;
        returns, per entry of ``entries`` in order, ``{key: {name:
        tensor}}`` on the mesh's first device, ready on the calling thread's
        current stream there."""
        out: Dict[int, Dict[str, Dict]] = {i: {} for i in entries}
        events: Dict[int, torch.cuda.Event] = {}
        steps = {}
        for i in entries:
            caller = (torch.cuda.current_stream(self.mesh[i])
                      if self._streams[i] is not None else None)
            with self._on(i):
                if caller is not None:
                    self._streams[i].wait_stream(caller)
                steps[i] = iter(work(i))
        while steps:
            for i in list(steps):
                with self._on(i):
                    try:
                        key, value = next(steps[i])
                    except StopIteration:
                        if self._streams[i] is not None:
                            events[i] = torch.cuda.Event()
                            events[i].record(self._streams[i])
                        del steps[i]
                        continue
                out[i][key] = value
        return [self._gather(out[i], events.get(i), i) for i in entries]

    def _gather(self, results: Dict[str, Dict], event, i: int):
        """Entry i's tensors on the mesh's first device: the calling
        thread's stream on entry i's card waits for the entry's event and
        marks the tensors as used there (the copy, or on the first card the
        merge, runs on it); a copy across cards then orders itself against
        the first card's current stream."""
        dst = self.mesh[0]
        if event is not None:
            stream = torch.cuda.current_stream(self.mesh[i])
            stream.wait_event(event)
            for res in results.values():
                for v in res.values():
                    v.record_stream(stream)
        return {key: {name: v.to(dst, non_blocking=True)
                      for name, v in res.items()}
                for key, res in results.items()}
