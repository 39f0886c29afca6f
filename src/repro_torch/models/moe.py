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
"""
from __future__ import annotations

import numpy as np
import torch

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

    def forward(self, x):
        return moe_apply(self, self.cfg, x)


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
    ce = torch.bincount(idx.reshape(-1), minlength=m.n_experts).float()
    ce = ce / (t * m.n_experts_per_tok)
    aux = m.n_experts * torch.sum(me * ce)
    return gates, idx, aux


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
    counts = torch.bincount(flat_expert, minlength=n_experts)
    seg_start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=idx.device) - seg_start[e_sorted]
    return order, e_sorted, t_sorted, pos, pos < c


def moe_apply(p, cfg, x):
    """x: [B,S,d] -> (y [B,S,d], aux_loss)."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e = m.n_experts
    xt = x.reshape(t, d)
    gates, idx, aux = route(p, cfg, xt)                    # [T,k]
    k = m.n_experts_per_tok
    c = capacity(cfg, t)
    order, e_sorted, t_sorted, pos, keep = dispatch(idx, e, c)
    g_sorted = gates.reshape(-1)[order]

    # the reference's out-of-bounds "drop" scatter: a dropped pair goes to
    # a spare row (E, C) that is cut away, so no host sync picks the kept
    dest_e = torch.where(keep, e_sorted, e)
    dest_c = torch.where(keep, pos, c)
    buf = torch.zeros((e + 1, c + 1, d), dtype=x.dtype, device=x.device)
    buf[dest_e, dest_c] = xt[t_sorted]
    xe = buf[:e, :c]

    # expert FFN (batched swiglu over E), fp32 accumulation, bf16 between
    g = L.bmatmul(xe, p.wi)
    u = L.bmatmul(xe, p.wu)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * u
    ye = L.bmatmul(h, p.wo)

    # combine: gather back, gate-weight, then per token its pairs in
    # ascending expert order (the reference's scatter-add order)
    y_pairs = ye[torch.clamp(dest_e, max=e - 1), torch.clamp(dest_c, max=c - 1)]
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
