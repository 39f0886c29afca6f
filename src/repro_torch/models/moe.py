"""Mixture-of-Experts layer: sort-based capacity dispatch (port of
``repro.models.moe``).

Tokens are routed top-k, (token, expert) pairs are sorted by expert
(stable), truncated at per-expert capacity C, written into a dense [E, C,
d] buffer, pushed through batched expert FFNs and combined back with gate
weighting.  DeepSeek-V3-style sigmoid gating normalized over the selected
experts, plus always-on shared experts.

Orders that decide results follow the reference's: top-k ties go to the
lower expert index, the pair sort is stable (which pairs a full expert
drops depends on it), and each token's pairs are summed in ascending
expert order, one rounding per add, without atomics, so that two runs are
bitwise equal.

On a mesh (``x`` a DTensor) the routing statistics and the dispatch plan
are decided over the global token set, as the reference's are: every rank
gathers the tokens and the router and runs the same plan, so the pairs
dropped at capacity are the one-device run's.  The experts are split over
``model`` on E ("expert", the reference's layout): each rank fills the
[E/n, C, d] buffer of its own experts, runs their FFN and combines their
pairs into a partial sum over the expert axes; what the dispatch and the
combine read (the tokens, the gates) has its gradient summed over those
axes, the routing's own stays replicated.
"""
from __future__ import annotations

import types

import numpy as np
import torch

from repro_torch.distributed.sharding import shard_activation
from repro_torch.models import layers as L


class MoE(L.Module):
    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        self.cfg = cfg
        m = cfg.moe
        d, ff, e = cfg.d_model, m.d_ff_expert, m.n_experts
        self.param("router", (d, e), torch.float32, device, 1.0 / np.sqrt(d))
        self.param("wi", (e, d, ff), dtype, device, 1.0 / np.sqrt(d))
        self.param("wu", (e, d, ff), dtype, device, 1.0 / np.sqrt(d))
        self.param("wo", (e, ff, d), dtype, device, 1.0 / np.sqrt(ff))
        if m.n_shared_experts:
            self.shared = L.SwiGLU(d, ff * m.n_shared_experts, dtype, device)
        self.routes = None       # a list: each forward appends (idx, keep)

    def forward(self, x):
        return moe_apply(self, self.cfg, x, routes=self.routes)


def capacity(cfg, n_tokens: int) -> int:
    m = cfg.moe
    c = int(m.capacity_factor * n_tokens * m.n_experts_per_tok / m.n_experts)
    return max(8, (c + 7) // 8 * 8)   # pad to multiple of 8 for tiling


def route(p, cfg, x):
    """Router: returns (gates [T,k], expert_ids [T,k], aux_loss scalar)."""
    m = cfg.moe
    t = x.shape[0]
    logits = x.float() @ p.router
    scores = torch.sigmoid(logits)                        # DeepSeek-V3 gating
    # lax.top_k: descending, ties to the lower index (a stable sort)
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    idx = order[:, :m.n_experts_per_tok]
    gates = torch.gather(scores, 1, idx)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # load-balance aux loss (Switch-style, on softmax probabilities)
    probs = torch.softmax(logits, dim=-1)
    me = probs.mean(dim=0)                                 # [E]
    ce = _counts(idx.reshape(-1), m.n_experts).float()
    ce = ce / (t * m.n_experts_per_tok)
    aux = m.n_experts * torch.sum(me * ce)
    return gates, idx, aux


def _counts(flat, n: int):
    """Per-expert pair counts of ``flat`` (``bincount`` with a static
    shape, which a fake tensor can trace)."""
    return torch.zeros(n, dtype=torch.int64, device=flat.device).index_add_(
        0, flat, torch.ones_like(flat))


def dispatch(idx, n_experts: int, c: int):
    """The reference's dispatch plan for expert ids ``idx`` [T,k]: the
    stable expert order of the flattened pairs, each sorted pair's expert,
    token and slot within its expert, and whether it fits in capacity
    ``c``."""
    t, k = idx.shape
    flat_expert = idx.reshape(-1)
    order = torch.sort(flat_expert, stable=True).indices
    e_sorted = flat_expert[order]
    t_sorted = order // k                                  # repeat(arange(t), k)
    counts = _counts(flat_expert, n_experts)
    seg_start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=idx.device) - seg_start[e_sorted]
    return order, e_sorted, t_sorted, pos, pos < c


def _replicated(t):
    """A DTensor's global value on every rank, as a local tensor."""
    from torch.distributed.tensor import Replicate
    mesh = t.device_mesh
    return t.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()


def _as_replicated(t, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _sum_grad(t, mesh, dims):
    """``t`` (the same on every rank) unchanged, its gradient (partial over
    the mesh dims ``dims``) summed over them."""
    from torch.distributed.tensor import Partial, Replicate
    return _as_replicated(t, mesh).to_local(grad_placements=[
        Partial() if i in dims else Replicate() for i in range(mesh.ndim)])


def _experts_here(w, mesh):
    """(the mesh dims of size > 1 that split the experts, this rank's first
    expert, its expert count) of an expert weight ``w`` [E, ...]."""
    from torch.distributed.tensor import Shard
    dims = tuple(i for i, pl in enumerate(w.placements)
                 if pl == Shard(0) and mesh.size(i) > 1)
    n = w.to_local().shape[0]
    first = 0
    for i in dims:                                   # major first
        first = first * mesh.size(i) + mesh.get_local_rank(i)
    return dims, first * n, n


def moe_apply(p, cfg, x, routes=None):
    """x: [B,S,d] -> (y [B,S,d], aux_loss).  ``routes``, a list, gets
    (expert ids [T,k], kept [T*k] in the sorted pair order) appended."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e = m.n_experts
    mesh = x.device_mesh if isinstance(x, DTensor) else None
    if mesh is not None:      # the global tokens and router on every rank
        x_in, x = x, _replicated(x)
        rp = types.SimpleNamespace(router=_replicated(p.router))
        ep, e0, e_here = _experts_here(p.wi, mesh)
        xe_pl = [Shard(0) if pl == Shard(0) else Replicate()
                 for pl in p.wi.placements]
    else:
        rp, ep, e0, e_here = p, (), 0, e
    xt = x.reshape(t, d)
    gates, idx, aux = route(rp, cfg, xt)                   # [T,k]
    k = m.n_experts_per_tok
    c = capacity(cfg, t)
    order, e_sorted, t_sorted, pos, keep = dispatch(idx, e, c)
    if routes is not None:
        routes.append((idx.detach(), keep.detach()))
    g_sorted = gates.reshape(-1)[order]
    mine = keep
    if ep:                    # this rank's experts only
        mine = keep & (e_sorted >= e0) & (e_sorted < e0 + e_here)
        xt, g_sorted = _sum_grad(xt, mesh, ep), _sum_grad(g_sorted, mesh, ep)

    # the reference's out-of-bounds "drop" scatter: a dropped pair goes to
    # a spare row (E, C) that is cut away, so no host sync picks the kept
    dest_e = torch.where(mine, e_sorted - e0, e_here)
    dest_c = torch.where(mine, pos, c)
    buf = torch.zeros((e_here + 1, c + 1, d), dtype=x.dtype, device=x.device)
    buf[dest_e, dest_c] = shard_activation(xt[t_sorted], "batch")
    xe = buf[:e_here, :c]
    if mesh is not None:
        xe = DTensor.from_local(xe, mesh, xe_pl, run_check=False)
    xe = shard_activation(xe, "expert")                    # [E,C,d] E->model

    # expert FFN (batched swiglu over E), fp32 accumulation, bf16 between
    g = L.bmatmul(xe, p.wi)
    u = L.bmatmul(xe, p.wu)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    ye = shard_activation(L.bmatmul(h, p.wo), "expert")
    if mesh is not None:
        ye = ye.redistribute(mesh, xe_pl).to_local()

    # combine: gather back, gate-weight, then per token its pairs in
    # ascending expert order (the reference's scatter-add order)
    y_pairs = ye[torch.clamp(dest_e, max=e_here - 1),
                 torch.clamp(dest_c, max=c - 1)]
    y_pairs = y_pairs * (g_sorted * mine)[:, None].to(x.dtype)
    y_pairs = shard_activation(y_pairs, "batch")
    rank = torch.empty_like(order)
    rank[order] = torch.arange(t * k, device=x.device)     # pair -> sorted slot
    by_expert = torch.sort(idx, dim=-1).indices            # [T,k]
    slots = torch.gather(rank.view(t, k), 1, by_expert)
    yt = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        yt = yt + y_pairs[slots[:, j]]
    y = shard_activation(yt, "batch").view(b, s, d)
    if mesh is not None:      # summed over the expert axes
        x = x_in
        y = DTensor.from_local(y, mesh, [
            Partial() if i in ep else Replicate() for i in range(mesh.ndim)],
            run_check=False).redistribute(mesh, [
                Replicate() if pl.is_partial() else pl for pl in x.placements])
        aux = _as_replicated(aux, mesh)

    if m.n_shared_experts:
        y = y + L.swiglu(p.shared, x)
    return y, aux
