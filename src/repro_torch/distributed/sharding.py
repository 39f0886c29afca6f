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
instead, so nothing is padded or cropped.

The LM substrate's half (FSDP x TP x EP with divisibility fallback) runs on
an `LMMesh`, a ``torch.distributed`` ``DeviceMesh`` with axis names, whose
tensors are DTensors:

* ``fsdp``   -- parameter shards over the data-parallel axes (ZeRO-3
               style): ``("pod", "data")`` on a multi-pod mesh,
               ``("data",)`` otherwise;
* ``tensor`` -- tensor-parallel over ``model``;
* ``expert`` -- expert-parallel over ``model`` (the MoE expert dim).

The rules (`PARAM_RULES`, verbatim) are name-based, matched against the
reference's parameter path, and produce a spec `P` for the reference's
stacked parameter; a mesh axis that does not divide its dim is dropped.
The port names a parameter by that path with the stacked axes spelled out
(``stack.3.attn.wq`` is layer 3 of ``stack/attn/wq`` [L, ...]), so
`param_pspec_tree` gives each parameter the reference's spec of its stack
without the stacked entries.  The rules read only a mesh's ``axis_names``,
``shape`` (a dict) and ``size``.
"""
from __future__ import annotations

import contextlib
import re
import threading
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


# ===========================================================================
# the LM substrate: parameter rules, activation specs, DTensor placements
# ===========================================================================
class P(tuple):
    """The port's PartitionSpec: per tensor dim, a mesh axis name, a tuple
    of names (sharded over their product, major first) or ``None``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class LMMesh:
    """A named mesh of ranks for the LM substrate: ``axis_names``, ``shape``
    ({name: size}) and ``size``, over a ``torch.distributed`` ``DeviceMesh``
    (``device_mesh``; None for a mesh of shapes only, which the rules and
    the specs take as well)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device_mesh=None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} for axes "
                             f"{tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.dims = tuple(int(s) for s in shape)
        self.shape = dict(zip(self.axis_names, self.dims))
        self.size = int(np.prod(self.dims))
        self.device_mesh = device_mesh

    @classmethod
    def from_device_mesh(cls, device_mesh) -> "LMMesh":
        return cls(tuple(device_mesh.mesh.shape), device_mesh.mesh_dim_names,
                   device_mesh)

    @property
    def tag(self) -> str:
        """``"16x16"``: the reference's mesh tag."""
        return "x".join(str(s) for s in self.dims)

    def __repr__(self) -> str:
        return f"LMMesh({self.shape})"


_state = threading.local()


@contextlib.contextmanager
def use_mesh(mesh: LMMesh):
    """Set the ambient mesh of `shard_activation` and the specs."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def current_mesh() -> Optional[LMMesh]:
    """The ambient mesh set by `use_mesh`, or None outside any context."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def activation_dp_over_model(flag: bool):
    """When True, activation batch dims shard over (dp axes + model):
    pure-DP activations for archs whose heads can't TP-shard."""
    prev = getattr(_state, "dp_over_model", False)
    _state.dp_over_model = flag
    try:
        yield
    finally:
        _state.dp_over_model = prev


def _dp_over_model_active() -> bool:
    return getattr(_state, "dp_over_model", False)


def _resolve_axis(logical, mesh):
    if logical is None:
        return None
    if logical in ("fsdp", "dp"):
        return dp_axes(mesh)
    if logical in ("tensor", "expert"):
        return ("model",) if "model" in mesh.axis_names else ()
    raise ValueError(f"unknown logical axis {logical!r}")


def resolve_spec(logical_spec, shape, mesh) -> P:
    """logical spec + concrete shape -> `P` with the divisibility
    fallback (left-padded with None for stacked leading dims)."""
    pad = len(shape) - len(logical_spec)
    logical_spec = (None,) * pad + tuple(logical_spec)
    out = []
    for dim, logical in zip(shape, logical_spec):
        axes = _resolve_axis(logical, mesh)
        if not axes:
            out.append(None)
            continue
        kept = []
        prod = 1
        for a in axes:
            asz = mesh.shape[a]
            if dim % (prod * asz) == 0:
                kept.append(a)
                prod *= asz
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(tuple(kept))
    return P(*out)


# ordered; the first match on the reference's path wins
PARAM_RULES = [
    # embeddings / lm head: [V, D]
    (r"(emb|head|patch_proj)/w$",        ("tensor", "fsdp")),
    (r"pos_emb$",                        (None, None)),
    # MoE experts: [E, d, ff] / [E, ff, d]
    (r"moe/w[iu]$",                      ("expert", "fsdp", None)),
    (r"moe/wo$",                         ("expert", None, "fsdp")),
    (r"moe/router$",                     ("fsdp", None)),
    # attention in-projections: [d, X]
    (r"(wq|wk|wv|wuq|wdq|wdkv|wkr)$",    ("fsdp", "tensor")),
    (r"(wuk|wuv)$",                      (None, "tensor")),   # [r, H*hd]
    # out-projections: [X, d]
    (r"wo$",                             ("tensor", "fsdp")),
    # MLP / xlstm / ssm in-projections: [d, F]
    (r"(wi|wu|in_proj|up_proj)$",        ("fsdp", "tensor")),
    (r"(out_proj|down_proj)$",           ("tensor", "fsdp")),
    # biases on tensor-sharded outputs
    (r"b[qkv]$",                         ("tensor",)),
    (r"bi$",                             ("tensor",)),
    (r"(bo|b)$",                         (None,)),
    # SSM per-channel params: [d_inner] or [H] -- shard over tensor
    (r"(A_log|D|dt_bias)$",              ("tensor",)),
    (r"conv/w$",                         (None, "tensor")),
    (r"conv/b$",                         ("tensor",)),
]


def pspec_for(path_str: str, shape, mesh) -> P:
    """The `P` of one reference parameter (its '/'-joined path and its
    stacked shape): the first `PARAM_RULES` match wins, 2D+ parameters fall
    back to (fsdp, tensor) on the trailing dims, scalars and norm scales
    replicate."""
    for pat, logical in PARAM_RULES:
        if re.search(pat, path_str):
            return resolve_spec(logical, shape, mesh)
    if len(shape) >= 2:
        return resolve_spec(("fsdp", "tensor"), shape, mesh)
    return P()


def reference_path(name: str) -> Tuple[str, Tuple[int, ...]]:
    """A port parameter name -> (the reference's path, its stack index):
    ``stack.3.attn.wq`` -> (``stack/attn/wq``, (3,))."""
    parts = name.split(".")
    return ("/".join(x for x in parts if not x.isdigit()),
            tuple(int(x) for x in parts if x.isdigit()))


def param_pspec_tree(params_shapes: Dict[str, Sequence[int]], mesh
                     ) -> Dict[str, P]:
    """``{name: shape}`` (or ``{name: tensor}``) of a model's parameters ->
    ``{name: P}``: each parameter's stack is given its reference shape
    (the stacked axes' sizes, then the parameter's), `pspec_for` names its
    spec, and the parameter takes that spec without the stacked entries."""
    shapes = {k: tuple(getattr(v, "shape", v)) for k, v in
              params_shapes.items()}
    depth: Dict[str, List[int]] = {}
    for name in shapes:
        path, idx = reference_path(name)
        top = depth.setdefault(path, [0] * len(idx))
        for j, i in enumerate(idx):
            top[j] = max(top[j], i + 1)
    out = {}
    for name, shape in shapes.items():
        path, idx = reference_path(name)
        spec = pspec_for(path, tuple(depth[path]) + shape, mesh)
        out[name] = P(*spec[len(idx):])
    return out


def placements(spec, mesh: LMMesh, ndim: Optional[int] = None):
    """A `P` -> DTensor placements, one per mesh axis: ``Shard(i)`` where
    tensor dim i names the axis, ``Replicate()`` elsewhere.  A dim sharded
    over a tuple of axes takes them major first (the mesh's order)."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh.axis_names]
    for i, ax in enumerate(tuple(spec)):
        for a in ((ax,) if isinstance(ax, str) else (ax or ())):
            out[mesh.axis_names.index(a)] = Shard(i)
    return out


def make_param_shardings(params_shapes, mesh: LMMesh):
    """`param_pspec_tree` with every spec turned into its DTensor
    placements."""
    return {k: placements(s, mesh)
            for k, s in param_pspec_tree(params_shapes, mesh).items()}


def _act_spec(kind: str, rank: int, mesh) -> P:
    dp = dp_axes(mesh)
    if _dp_over_model_active() and "model" in mesh.axis_names:
        dp = dp + ("model",)
        if kind == "logits":   # vocab can't also use model -- pure DP
            return P(dp, *([None] * (rank - 1)))
    dp = dp[0] if len(dp) == 1 else dp
    if kind == "hidden":      # [B, S, D]
        return P(dp, *([None] * (rank - 1)))
    if kind == "expert":      # [E, C, D] -- EP on E only
        return P("model", *([None] * (rank - 1)))
    if kind == "logits":      # [B, S, V]
        return P(dp, None, "model")
    if kind == "batch":       # any batch-leading tensor
        return P(dp, *([None] * (rank - 1)))
    if kind == "kv_cache":    # [B, S, KVH, hd] -- batch-sharded
        return P(dp, *([None] * (rank - 1)))
    raise ValueError(kind)


def largest_divisible_prefix(dim: int, axes, mesh):
    """Longest prefix of ``axes`` whose size product divides ``dim``."""
    kept = []
    prod = 1
    for a in axes:
        if dim % (prod * mesh.shape[a]) != 0:
            break
        kept.append(a)
        prod *= mesh.shape[a]
    if not kept:
        return None
    return kept[0] if len(kept) == 1 else tuple(kept)


def activation_spec(shape, kind: str, mesh) -> P:
    """`_act_spec` with the divisibility fallback: per dim the largest
    prefix of its grouped axes that divides it (so dp_over_model degrades
    to plain dp, not to replicated)."""
    spec = _act_spec(kind, len(shape), mesh)
    concrete = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            concrete.append(None)
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        concrete.append(largest_divisible_prefix(dim, axes, mesh))
    return P(*concrete)


def shard_activation(x, kind: str):
    """Redistribute a DTensor to the activation spec of ``kind`` on the
    ambient mesh; the identity without one, on a mesh of size 1, or for a
    plain tensor."""
    mesh = current_mesh()
    if mesh is None or mesh.size == 1 or not is_dtensor(x):
        return x
    want = placements(activation_spec(x.shape, kind, mesh), mesh)
    if tuple(x.placements) == tuple(want):
        return x
    if any(p.is_partial() for p in x.placements):
        # reduce the partial axes first, alone: a partial embedding lookup
        # carries a mask of the local shape that a combined plan may
        # outlive
        from torch.distributed.tensor import Replicate
        x = x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                           else p for p in x.placements])
    return x.redistribute(x.device_mesh, want)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def batch_pspec(mesh, rank: int = 2) -> P:
    """`P` sharding only the leading (batch) dim over the data axes."""
    dp = dp_axes(mesh)
    dp = dp[0] if len(dp) == 1 else dp
    return P(dp, *([None] * (rank - 1)))


def local_shard(t):
    """A DTensor's local shard (a view of its storage); any other tensor
    as it is."""
    return t.to_local() if is_dtensor(t) else t


def sharded_axes(t) -> Tuple[int, ...]:
    """The mesh dims of size > 1 over which a DTensor is sharded (``()``
    for a plain tensor): a value reduced from its local shard is partial
    over these."""
    if not is_dtensor(t):
        return ()
    mesh = t.device_mesh
    return tuple(i for i, pl in enumerate(t.placements)
                 if pl.is_shard() and mesh.size(i) > 1)


def shard_block(n: int, mesh, dims: Sequence[int]) -> Tuple[int, int]:
    """(first index, length) of this rank's block of a dim of size ``n``
    sharded over the mesh dims ``dims`` (major first, each split as
    ``torch.chunk`` splits, as DTensor's ``Shard`` does)."""
    start = 0
    for i in dims:
        size = -(-n // mesh.size(i))
        r = mesh.get_local_rank(i)
        start += min(r * size, n)
        n = max(0, min(size, n - r * size))
    return start, n


def reduce_partial(value: torch.Tensor, mesh, axes: Sequence[int],
                   op: str = "sum") -> torch.Tensor:
    """``value``, a local partial result over the mesh dims ``axes``,
    reduced over them by ``op`` ("sum" | "max"): a plain tensor, the same
    on every rank.  No axes: ``value`` itself."""
    if not axes:
        return value
    from torch.distributed.tensor import DTensor, Partial, Replicate
    pl = [Partial(op) if i in axes else Replicate()
          for i in range(mesh.ndim)]
    return DTensor.from_local(value, mesh, pl, run_check=False).full_tensor()


def like(local: torch.Tensor, ref):
    """``local`` (a rank's shard) as a DTensor of ``ref``'s mesh and
    placements when ``ref`` is one; else ``local`` itself."""
    if not is_dtensor(ref):
        return local
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, ref.device_mesh, ref.placements,
                              run_check=False)


def shard_module(model: torch.nn.Module, mesh: LMMesh, shardings: Dict,
                 place=None):
    """Replace each parameter of ``model`` (the same full value on every
    rank) by a DTensor parameter of ``shardings[name]``'s placements on
    ``mesh``, keeping its local shard only: ``place(tensor, placements,
    mesh)``, by default ``distribute_tensor``.  Returns ``model``."""
    from torch.distributed.tensor import distribute_tensor
    if place is None:
        def place(t, pls, mesh):
            return distribute_tensor(t, mesh.device_mesh, pls)
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner)
        with torch.no_grad():
            dt = place(p.detach(), shardings[name], mesh)
        mod.register_parameter(leaf, torch.nn.Parameter(
            dt, requires_grad=p.requires_grad))
    return model


def distribute(tree, shardings, mesh: LMMesh):
    """A tree of tensors (the same full value on every rank) as DTensors
    of the matching tree of placements."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k], mesh) for k, v in tree.items()}
    return distribute_tensor(tree, mesh.device_mesh, shardings)


def batch_local(fn, *args, dims: Sequence[int] = (0,)):
    """``fn(*args)`` run on each rank's local block when the first
    argument is a DTensor: for work independent along ``dims`` (the batch,
    and for attention the heads).  The first argument's shards on ``dims``
    are kept (other axes gathered); every argument of 2+ dims with its
    sizes on ``dims`` takes the same placements, any other DTensor is
    gathered whole (its gradient is then partial over the kept axes).
    Tensor outputs of the first argument's sizes on ``dims`` come back with
    its placements, others replicated.  Plain tensors: ``fn(*args)``."""
    lead = args[0]
    if not is_dtensor(lead):
        return fn(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = lead.device_mesh
    keep = [p if p.is_shard() and p.dim in dims else Replicate()
            for p in lead.placements]
    rep = [Replicate()] * mesh.ndim
    partial = [Partial() if p.is_shard() else Replicate() for p in keep]

    def batched(t):
        return t.dim() >= 2 and all(
            d < t.dim() and t.shape[d] == lead.shape[d] for d in dims)

    def local(t):
        if not isinstance(t, torch.Tensor):
            return t
        if not is_dtensor(t):
            t = DTensor.from_local(t, mesh, rep, run_check=False)
        if batched(t):
            return t.redistribute(mesh, keep).to_local()
        return t.redistribute(mesh, rep).to_local(grad_placements=partial)

    out = fn(*(local(a) for a in args))
    return _back(out, mesh, keep, rep, tuple(lead.shape), dims)


def _back(o, mesh, keep, rep, lead_shape, dims):
    """`batch_local`'s outputs as DTensors: those of the first argument's
    sizes on ``dims`` with its kept placements, the rest replicated.  A
    function of its own: a nested function that calls itself is a
    reference cycle, which would keep the first argument alive until the
    cyclic garbage collector runs."""
    from torch.distributed.tensor import DTensor
    if isinstance(o, torch.Tensor):
        big = o.dim() >= 2 and all(
            d < o.dim() and o.shape[d] * _shards(keep, mesh, d)
            == lead_shape[d] for d in dims)
        return DTensor.from_local(o, mesh, keep if big else rep,
                                  run_check=False)
    if isinstance(o, dict):
        return {k: _back(v, mesh, keep, rep, lead_shape, dims)
                for k, v in o.items()}
    if isinstance(o, (tuple, list)):
        return type(o)(_back(v, mesh, keep, rep, lead_shape, dims)
                       for v in o)
    return o


def _shards(pls, mesh, dim: int) -> int:
    n = 1
    for i, p in enumerate(pls):
        if p.is_shard() and p.dim == dim:
            n *= mesh.size(i)
    return n
