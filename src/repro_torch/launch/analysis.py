"""Per-rank op counting and roofline terms (port of
``repro/launch/analysis.py``).

The reference reads XLA's ``cost_analysis`` and the collectives of the
partitioned HLO.  The port has no compiled artifact: `OpCounter` is a
``TorchDispatchMode`` that sees each op a rank runs on its **local**
tensors (it lets DTensor decompose a global op first, and skips DTensor's
own shape propagation, which runs the global op on fake tensors), and
counts

* FLOPs of the matrix products (``torch.utils.flop_counter``'s registry:
  mm, bmm, addmm, baddbmm, convolutions, attention);
* bytes: each op's input and output tensors, views and ops that return no
  tensor (``.device`` and other queries, which move nothing) excepted.
  An upper bound: XLA's "bytes accessed" counts after fusion, here every
  intermediate goes to memory and back;
* collectives, by the reference's kind names, in bytes of each result on
  this rank;
* live bytes: each storage from the op that makes it until its last
  tensor dies; ``peak_bytes`` is the high-water mark, and ``at_peak`` the
  largest storages live there (bytes, the shape and dtype of the tensor
  that made each): what sets the peak.

Hardware model, per card (NVIDIA H100 80GB HBM3, 700 W; the data sheet's
dense rates): 989e12 bf16 FLOP/s, 3.35e12 B/s of HBM3, and 50e9 B/s of
collective bandwidth a card: NDR InfiniBand at 400 Gb/s, since both
16-wide production axes span more than one 8-card NVLink node.
"""
from __future__ import annotations

import contextlib
import heapq
import threading
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

PEAK_FLOPS = 989e12          # bf16 dense per card
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 50e9               # bytes/s per card across nodes (NDR 400 Gb/s)
CARD = "NVIDIA H100 80GB HBM3, 700 W"
PEAK_TENSORS = 6             # the largest live storages recorded at the peak

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-broadcast",
}
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd")

_propagating = threading.local()


@contextlib.contextmanager
def _propagation_marked():
    """Mark DTensor's shape propagation (the global op run on fake
    tensors to learn its output's shape), so that `OpCounter` skips it."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(ShardingPropagator, name, None)
    if orig is None:
        raise RuntimeError(f"ShardingPropagator has no {name}: this torch "
                           f"version's DTensor is not supported here")

    def marked(self, *args, **kwargs):
        prev = getattr(_propagating, "on", False)
        _propagating.on = True
        try:
            return orig(self, *args, **kwargs)
        finally:
            _propagating.on = prev

    setattr(ShardingPropagator, name, marked)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts what one rank runs (see the module docstring).  Use as a
    context manager; `track` adds tensors made before it (the arguments)
    to the live bytes."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives: Dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self.at_peak: list = []
        self._storages: Dict[int, list] = {}
        self._marks = contextlib.ExitStack()

    def __enter__(self):
        self._marks.enter_context(_propagation_marked())
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._marks.close()

    # ---------------- live bytes -------------------------------------------
    def track(self, t: torch.Tensor) -> None:
        key = t.untyped_storage()._cdata
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [t.untyped_storage().nbytes(), 0,
                                           list(t.shape), str(t.dtype)]
            self.live += entry[0]
            if self.live > self.peak:
                self.peak = self.live
                self.at_peak = [[e[0], e[2], e[3]] for e in heapq.nlargest(
                    PEAK_TENSORS, self._storages.values(),
                    key=lambda e: e[0])]
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    # ---------------- dispatch ---------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # let DTensor run its local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if getattr(_propagating, "on", False):
            return out
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if func.namespace in _COLLECTIVE_NS:
            kind = _COLLECTIVES.get(func._overloadpacket.__name__)
            if kind is not None:
                self.collectives[kind] = (self.collectives.get(kind, 0)
                                          + sum(_nbytes(t) for t in outs))
            return out
        packet = func._overloadpacket
        if packet in self._flop_registry:
            fargs, fkw = args, kwargs
            if func._overloadname == "dtype":     # mm/bmm(a, b, out_dtype)
                fargs, fkw = args[:2], {}
            self.flops += self._flop_registry[packet](*fargs, **fkw,
                                                      out_val=out)
        if not func.is_view and outs:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in ins + outs)
            seen = {id(t) for t in ins}
            for t in outs:
                if id(t) not in seen:
                    self.track(t)
        return out


def parse_collectives(counter: OpCounter) -> Dict[str, int]:
    """The collective bytes a counted run issued on this rank, by kind
    (``all-gather``, ``reduce-scatter``, ``all-reduce``, ``all-to-all``,
    ...): the result bytes of each."""
    return dict(counter.collectives)


def roofline_terms(flops: float, hbm_bytes: float, collective_bytes: float,
                   n_chips: int) -> Dict[str, float]:
    """The three roofline terms in seconds.  Every term is per-card work
    over per-card capability (the counts are a rank's); n_chips is only
    used for reporting."""
    compute_s = flops / PEAK_FLOPS
    memory_s = hbm_bytes / HBM_BW
    collective_s = collective_bytes / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    total = max(terms["compute_s"], terms["memory_s"], terms["collective_s"])
    terms["roofline_fraction"] = compute_s / total if total > 0 else 0.0
    return terms


def active_param_count(cfg, n_params: int) -> int:
    """MoE: subtract un-routed expert params (6·N_active·D convention)."""
    if getattr(cfg, "moe", None) is None:
        return n_params
    m = cfg.moe
    n_moe_layers = cfg.n_layers - m.n_dense_layers
    inactive = n_moe_layers * 3 * cfg.d_model * m.d_ff_expert \
        * (m.n_experts - m.n_experts_per_tok)
    return n_params - inactive


def model_flops(n_params: int, n_tokens: int, kind: str = "train") -> float:
    """6·N·D for train, 2·N·D for inference forward (N = active params)."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params * n_tokens


def cost_analysis_terms(counter: OpCounter) -> Dict[str, float]:
    """A counted run's per-rank FLOPs and bytes, under the reference's
    keys."""
    return {"hlo_flops": float(counter.flops),
            "hlo_bytes": float(counter.bytes)}
