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
bitwise equal.  The router product runs one sequence at a time
(`router_logits`), so that a token's logits do not depend on how many
rows share its GEMM.

On a mesh (``x`` a DTensor) the reference's layout is kept
(``src/repro/models/moe.py:91-116``): each rank routes its own data
shard's tokens and holds only their pairs ([T*k/dp, d]), and the experts
are split over ``model`` on E ("expert"): a rank's [E/ep, C, d] buffer
takes its own tokens' kept pairs for its own experts and is summed over
the data dims, its FFN runs on those experts, and its tokens' pairs come
back from them as a partial sum over the expert dims.  The experts'
products split over ``data`` as XLA splits the reference's (g and u on
the weights' split of d, or the weights gathered; `L.bmatmul`), and so
does the router's over ``model`` (`_router_split`).  The plan is the
global one: the expert ids [T,k] are gathered and every rank runs the
same `dispatch`, so the pairs dropped at capacity are the one-device
run's, and the aux loss takes the global counts and mean probabilities.
What the dispatch and the combine read (the tokens, the gates) has its
gradient summed over the expert dims; the router's is partial over the
data dims.  Under `plan_groups(n)` (a chunked prefill on a mesh) the plan
is made for ``n`` groups of consecutive batch rows, each with its own
capacity: the pairs the reference's chunks, run one after another, drop.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from repro_torch.distributed.sharding import (is_dtensor, reduce_partial,
                                              shard_activation, shard_block)
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


_state = threading.local()


@contextlib.contextmanager
def plan_groups(n: int):
    """Within: a MoE forward on a mesh (its batch a multiple of ``n``)
    plans each of ``n`` groups of consecutive rows alone (its own capacity,
    its own drops), as ``n`` chunks of the batch run in turn would."""
    prev = getattr(_state, "groups", 1)
    _state.groups = n
    try:
        yield
    finally:
        _state.groups = prev


def capacity(cfg, n_tokens: int) -> int:
    m = cfg.moe
    c = int(m.capacity_factor * n_tokens * m.n_experts_per_tok / m.n_experts)
    return max(8, (c + 7) // 8 * 8)   # pad to multiple of 8 for tiling


def route(p, cfg, x, seq=None):
    """Router: returns (gates [T,k], expert_ids [T,k], aux_loss scalar).
    ``seq``: the tokens a sequence (`router_logits`), by default all."""
    gates, idx, logits = _top_k(p.router, cfg, x, seq)
    # load-balance aux loss (Switch-style, on softmax probabilities)
    probs = torch.softmax(logits, dim=-1)
    me = probs.mean(dim=0)                                 # [E]
    return gates, idx, _aux(cfg, me, idx)


def router_logits(x, router, seq=None):
    """x [T,d] @ router [d,E] in fp32, one product for each ``seq`` rows
    (a sequence's tokens).  cuBLAS picks its algorithm, and with it the
    rounding, by the row count: products of one sequence each give a token
    the same logits whether one device routes all T tokens or a data
    shard its own, so the routes and drops of a mesh are one device's."""
    if seq is None or seq >= x.shape[0]:
        return x.float() @ router
    return torch.cat([x[i:i + seq].float() @ router
                      for i in range(0, x.shape[0], seq)])


def _top_k(router, cfg, x, seq):
    """(gates [T,k], expert ids [T,k], logits [T,E]) of tokens ``x``."""
    return _top_k_of(cfg, router_logits(x, router, seq))


def _top_k_of(cfg, logits):
    """(gates [T,k], expert ids [T,k], logits [T,E]) of router logits."""
    m = cfg.moe
    scores = torch.sigmoid(logits)                        # DeepSeek-V3 gating
    # lax.top_k: descending, ties to the lower index (a stable sort)
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    idx = order[:, :m.n_experts_per_tok]
    gates = torch.gather(scores, 1, idx)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, idx, logits


def _aux(cfg, me, idx):
    """The load-balance loss of the mean router probabilities ``me`` [E]
    and the expert ids ``idx`` [T,k] of every token."""
    m = cfg.moe
    ce = _counts(idx.reshape(-1), m.n_experts).float()
    ce = ce / idx.numel()
    return m.n_experts * torch.sum(me * ce)


def _counts(flat, n: int):
    """Per-expert pair counts of ``flat`` (``bincount`` with a static
    shape, which a fake tensor can trace)."""
    return torch.zeros(n, dtype=torch.int64, device=flat.device).index_add_(
        0, flat, torch.ones_like(flat))


def dispatch(idx, n_experts: int, c: int, groups: int = 1):
    """The reference's dispatch plan for expert ids ``idx`` [T,k]: the
    stable expert order of the flattened pairs, each sorted pair's expert,
    token and slot within its expert, and whether it fits in capacity
    ``c``.  ``groups``: the tokens form that many consecutive groups, each
    planned alone (sorted group first, then by expert); a pair's slot is
    its place in its group plus ``c`` times its group, so an expert has
    ``groups * c`` slots."""
    t, k = idx.shape
    flat_expert = idx.reshape(-1)
    key = flat_expert
    if groups > 1:                     # group-major keys: group * E + expert
        key = (torch.arange(t * k, device=idx.device) // (t // groups * k)
               * n_experts + flat_expert)
    order = torch.sort(key, stable=True).indices
    e_sorted = flat_expert[order]
    t_sorted = order // k                                  # repeat(arange(t), k)
    sorted_key = key[order] if groups > 1 else e_sorted
    counts = _counts(key, groups * n_experts)
    seg_start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=idx.device) - seg_start[sorted_key]
    keep = pos < c
    if groups > 1:
        pos = pos + sorted_key // n_experts * c
    return order, e_sorted, t_sorted, pos, keep


def _as_replicated(t, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _sum_grad(t, mesh, dims):
    """``t`` (the same on the ranks of the mesh dims ``dims``) unchanged,
    its gradient (partial over ``dims``) summed over them."""
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


def _experts(p, xe, dtype, rows=None):
    """The expert FFN (batched swiglu over E), fp32 accumulation, bf16
    between: [E,C,d] -> [E,C,d].  ``rows``: the slots an expert has in a
    group of a grouped plan (see `L.bmatmul`)."""
    g = L.bmatmul(xe, p.wi, rows)
    u = L.bmatmul(xe, p.wu, rows)
    if is_dtensor(g):
        h = _gate_by_slabs(g, u, dtype)
        del g, u              # autograd keeps what the backward needs
    else:
        h = torch.nn.functional.silu(g.float()).to(dtype) * u
    return L.bmatmul(h, p.wo)


def _gate_by_slabs(g, u, dtype):
    """``silu(g)`` in fp32, rounded to ``dtype``, times ``u``, on DTensors
    of the same placements: on each rank's [E/ep, C, ff] block by slabs of
    `L.INIT_SLAB` elements, so that no fp32 [E/ep, C, ff] temporary exists
    (XLA fuses the reference's upcast into the multiply)."""
    from torch.distributed.tensor import DTensor
    gl, ul = g.to_local(), u.to_local()
    ff = gl.shape[-1]
    gf, uf = gl.reshape(-1, ff), ul.reshape(-1, ff)
    h = torch.empty(uf.shape, dtype=dtype, device=uf.device)
    step = max(1, L.INIT_SLAB // ff)
    for i in range(0, gf.shape[0], step):
        h[i:i + step] = torch.nn.functional.silu(
            gf[i:i + step].float()).to(dtype) * uf[i:i + step]
    return DTensor.from_local(h.view(ul.shape), g.device_mesh, g.placements,
                              run_check=False, shape=g.shape,
                              stride=g.stride())


def moe_apply(p, cfg, x, routes=None):
    """x: [B,S,d] -> (y [B,S,d], aux_loss).  ``routes``, a list, gets
    (expert ids [T,k], kept [T*k] in the sorted pair order) appended."""
    if is_dtensor(x):
        return _moe_on_mesh(p, cfg, x, routes)
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e = m.n_experts
    xt = x.reshape(t, d)
    gates, idx, aux = route(p, cfg, xt, s)                 # [T,k]
    k = m.n_experts_per_tok
    c = capacity(cfg, t)
    order, e_sorted, t_sorted, pos, keep = dispatch(idx, e, c)
    if routes is not None:
        routes.append((idx.detach(), keep.detach()))
    g_sorted = gates.reshape(-1)[order]

    # the reference's out-of-bounds "drop" scatter: a dropped pair goes to
    # a spare row (E, C) that is cut away, so no host sync picks the kept
    dest_e = torch.where(keep, e_sorted, e)
    dest_c = torch.where(keep, pos, c)
    buf = torch.zeros((e + 1, c + 1, d), dtype=x.dtype, device=x.device)
    buf[dest_e, dest_c] = xt[t_sorted]
    ye = _experts(p, buf[:e, :c], x.dtype)

    # combine: gather back, gate-weight, then per token its pairs in
    # ascending expert order (the reference's scatter-add order)
    y_pairs = ye[torch.clamp(dest_e, max=e - 1),
                 torch.clamp(dest_c, max=c - 1)]
    y_pairs = y_pairs * (g_sorted * keep)[:, None].to(x.dtype)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(t * k, device=x.device)     # pair -> sorted slot
    by_expert = torch.sort(idx, dim=-1).indices            # [T,k]
    slots = torch.gather(rank.view(t, k), 1, by_expert)
    yt = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        yt = yt + y_pairs[slots[:, j]]
    y = yt.view(b, s, d)
    if m.n_shared_experts:
        y = y + L.swiglu(p.shared, x)
    return y, aux


def _router_split(n_seq, seq, mesh, dims, groups):
    """The expert dims ``dims`` over which a rank's ``n_seq`` sequences of
    ``seq`` tokens are routed, split (`_split_router_logits`), or ``()``.
    XLA splits the reference's router product over ``model`` (on K) in a
    train step, a decode and a chunked prefill's chunks (dbrx-132b's
    prefill_32k on (16, 16) too); a prefill run whole gathers the router
    and routes its tokens whole, and so do sequences that do not split
    evenly (8 decode tokens a data shard over 16 ranks of ``model``)."""
    n = int(np.prod([mesh.size(i) for i in dims]))
    if torch.is_grad_enabled() or groups > 1 or seq == 1:
        return dims if n_seq % n == 0 else ()
    return ()


def _split_router_logits(xl, router, seq, mesh, dims):
    """`router_logits` of a rank's tokens ``xl`` [T/dp, d] (sequences of
    ``seq`` tokens), the sequences split over the mesh dims ``dims`` and
    the logits gathered: the reference's split on K here on rows, whole
    sequences a GEMM, so that the logits stay one device's.  The gradient
    of ``xl`` is summed over ``dims``; the router's is partial over them.
    No dims: the rank's whole product."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not dims:
        return router_logits(xl, router, seq)
    q0, nq = shard_block(xl.shape[0] // seq, mesh, dims)
    rows = _sum_grad(xl, mesh, dims)[q0 * seq:(q0 + nq) * seq]
    e = router.shape[-1]
    return DTensor.from_local(
        router_logits(rows, router, seq), mesh,
        [Shard(0) if i in dims else Replicate() for i in range(mesh.ndim)],
        run_check=False, shape=(xl.shape[0], e), stride=(e, 1)).redistribute(
            mesh, [Replicate()] * mesh.ndim).to_local()


def _moe_on_mesh(p, cfg, x, routes):
    """`moe_apply` of a DTensor ``x``, in the reference's layout
    (``src/repro/models/moe.py:91-116``): the pairs and tokens a rank
    holds are its own data shard's ([T*k/dp, d], [T/dp, d]), the expert
    buffers its own experts' ([E/ep, C, d], E over ``model``)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    m = cfg.moe
    mesh = x.device_mesh
    b, s, d = x.shape
    t, k, e = b * s, m.n_experts_per_tok, m.n_experts
    groups = getattr(_state, "groups", 1)
    c = capacity(cfg, t // groups)
    cg = groups * c                                        # slots an expert
    ep, e0, e_here = _experts_here(p.wi, mesh)
    xe_pl = [Shard(0) if pl == Shard(0) else Replicate()
             for pl in p.wi.placements]
    # the tokens stay on their data shard: x's batch shards over the mesh
    # dims that do not split the experts, gathered over the others
    tok = tuple(i for i, pl in enumerate(x.placements)
                if pl == Shard(0) and mesh.size(i) > 1 and i not in ep)
    tok_pl = [Shard(0) if i in tok else Replicate() for i in range(mesh.ndim)]
    b0, b_here = shard_block(b, mesh, tok)
    t0, t_here = b0 * s, b_here * s
    xl = x.redistribute(mesh, tok_pl).to_local().reshape(t_here, d)

    # route the rank's own tokens (the router gathered; its gradient is
    # partial over the token dims and those its product is split over);
    # the plan stays global, so the pairs dropped at capacity are one
    # device's
    split = _router_split(b_here, s, mesh, ep, groups)
    router = p.router.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if i in tok or i in split else Replicate()
                         for i in range(mesh.ndim)])
    gates, idx_here, logits = _top_k_of(
        cfg, _split_router_logits(xl, router, s, mesh, split))
    me = reduce_partial(torch.softmax(logits, dim=-1).sum(dim=0), mesh,
                        tok) / t                              # [E]
    idx = DTensor.from_local(
        idx_here.view(b_here, s, k), mesh, tok_pl, run_check=False,
        shape=(b, s, k), stride=(s * k, k, 1)).full_tensor().view(t, k)
    aux = _as_replicated(_aux(cfg, me, idx), mesh)
    order, _, _, pos, keep = dispatch(idx, e, c, groups)
    if routes is not None:      # a group's pairs follow the group before
        tg = t // groups
        routes.extend((idx[i * tg:(i + 1) * tg].detach(),
                       keep[i * tg * k:(i + 1) * tg * k].detach())
                      for i in range(groups))
    slot = torch.empty_like(order)
    slot[order] = torch.arange(t * k, device=x.device)     # pair -> sorted slot
    slot = slot[t0 * k:(t0 + t_here) * k].view(t_here, k)  # the rank's pairs
    mine = keep[slot] & (idx_here >= e0) & (idx_here < e0 + e_here)

    # dispatch: each rank writes its own kept pairs for its own experts
    # into a flat [E/ep * C + 1, d] buffer (the last row takes the rest and
    # is cut away); every slot has one writer over the token dims, so
    # their sum is the one-device buffer (but for -0.0 + 0.0 = +0.0)
    dest = torch.where(mine, (idx_here - e0) * cg + pos[slot], e_here * cg)
    buf = torch.zeros((e_here * cg + 1, d), dtype=x.dtype, device=x.device)
    buf[dest] = _sum_grad(xl, mesh, ep)[:, None]           # k pairs a token
    xe = DTensor.from_local(
        buf[:e_here * cg].view(e_here, cg, d), mesh,
        [Partial() if i in tok else pl for i, pl in enumerate(xe_pl)],
        run_check=False).redistribute(mesh, xe_pl)
    del buf                   # the sum is a tensor of its own: free the parts
    xe = shard_activation(xe, "expert")                    # [E,C,d] E->model
    ye = shard_activation(_experts(p, xe, x.dtype, c), "expert")
    del xe                    # autograd keeps what the backward needs
    # a rank reads only its own tokens' rows: ye's gradient is partial
    # over the token dims
    ye = ye.redistribute(mesh, xe_pl).to_local(grad_placements=[
        Partial() if i in tok else pl for i, pl in enumerate(xe_pl)])
    ye = ye.reshape(e_here * cg, d)

    # combine: gate-weight, then per token its pairs in ascending expert
    # order; a partial sum over the expert dims
    w = (_sum_grad(gates, mesh, ep) * mine).to(x.dtype)
    by_expert = torch.sort(idx_here, dim=-1).indices       # [T/dp,k]
    dest = torch.gather(dest, 1, by_expert).clamp(max=e_here * cg - 1)
    w = torch.gather(w, 1, by_expert)
    yt = torch.zeros((t_here, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        yt = yt + ye[dest[:, j]] * w[:, j, None]
    y = DTensor.from_local(
        yt.view(b_here, s, d), mesh, [
            Shard(0) if i in tok else Partial() if i in ep else Replicate()
            for i in range(mesh.ndim)], run_check=False, shape=(b, s, d),
        stride=(s * d, d, 1)).redistribute(mesh, [
            Replicate() if pl.is_partial() else pl for pl in x.placements])
    if m.n_shared_experts:
        y = y + L.swiglu(p.shared, x)
    return y, aux
