"""Per-family blocks and their stacks (port of ``repro.models.blocks``).

The reference stacks homogeneous layers along a leading axis and scans
them; here each stack is an ``nn.ModuleList`` walked by a Python loop, and
the heterogeneous patterns (xLSTM's mLSTM/sLSTM interleave, Zamba2's
shared-attention insertions, DeepSeek's dense->MoE split) are lists of
super-layers.  A stack's decode takes the reference's stacked cache
(leading layer axis, and the super-layer axes of xLSTM and Zamba) and
writes each layer's slice in place.

Remat policy (config ``remat``): 'nothing' | 'dots' | 'full' wraps each
layer, or each super-layer, in activation checkpointing while grad is
enabled, as the reference wraps each scan body in ``jax.checkpoint``.
"""
from __future__ import annotations

import contextlib
import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.distributed.sharding import shard_activation
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S


# 'dots' saves the GEMMs without batch dimensions (``mm``, ``addmm``, and
# ``mm`` with ``out_dtype`` inside ``layers.MatmulF32``) and recomputes the
# rest, ``bmm`` included: ``checkpoint_dots_with_no_batch_dims``
_SAVED_DOTS = (torch.ops.aten.mm, torch.ops.aten.addmm)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op.overloadpacket in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def maybe_remat(fn, remat: str):
    """``fn``, or ``fn`` under activation checkpointing while grad is
    enabled: 'nothing' | 'dots' (save the dots without batch dimensions)
    | anything else: 'full' (save only the inputs)."""
    if remat == "nothing" or not torch.is_grad_enabled():
        return fn
    if remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _dots_policy))
    return functools.partial(checkpoint, fn, use_reentrant=False)


def _slice(cache, i):
    """Layer ``i``'s view of a stacked cache (a dict of tensors)."""
    return {k: v[i] if isinstance(v, torch.Tensor) else _slice(v, i)
            for k, v in cache.items()}


def _gathered(cache, moved):
    """`batch_sharded`'s gather, recording each (leaf, gathered) pair in
    ``moved``.  A function of its own: a nested function that calls itself
    is a reference cycle, which would hold the gathered caches until the
    cyclic garbage collector runs."""
    if isinstance(cache, dict):
        return {k: _gathered(v, moved) for k, v in cache.items()}
    g = shard_activation(cache, "kv_cache")
    if g is not cache:
        moved.append((cache, g))
    return g


@contextlib.contextmanager
def batch_sharded(cache):
    """A layer's cache for its decode.  On a mesh, each DTensor leaf
    sharded otherwise than on its batch (the sequence- or head-sharded
    KV of ``specs.cache_pspecs``) is gathered to the "kv_cache" layout
    for the step, and written back into its own placements after it."""
    moved = []
    yield _gathered(cache, moved)
    for t, g in moved:
        t.copy_(g.redistribute(t.device_mesh, t.placements))


# ===========================================================================
# decoder block: (GQA | MLA) attention + (SwiGLU | MoE) FFN, pre-RMSNorm
# ===========================================================================
class DecoderBlock(L.Module):
    def __init__(self, cfg, *, use_moe=False, dtype, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = L.RMSNorm(cfg.d_model, device)
        self.attn = (A.MLA(cfg, dtype, device) if cfg.mla is not None
                     else A.GQA(cfg, dtype, device))
        self.ln2 = L.RMSNorm(cfg.d_model, device)
        if use_moe:
            self.moe = M.MoE(cfg, dtype, device)
        else:
            self.mlp = L.SwiGLU(cfg.d_model, cfg.d_ff, dtype, device)

    def _ffn(self, h):
        """h + FFN(ln2(h)) and the MoE's aux loss (0 for a dense FFN)."""
        hn = self.ln2(h, self.cfg.norm_eps)
        if hasattr(self, "moe"):
            f, aux = self.moe(hn)
        else:
            f, aux = self.mlp(hn), torch.zeros((), device=h.device)
        return h + f, aux

    def forward(self, h, positions, *, causal=True):
        """Returns (h, aux_loss)."""
        hn = self.ln1(h, self.cfg.norm_eps)
        if self.cfg.mla is not None:
            a, _, _ = self.attn(hn, positions, causal=causal)
        else:
            a = self.attn(hn, positions, causal=causal)
        h, aux = self._ffn(shard_activation(h + a, "hidden"))
        return shard_activation(h, "hidden"), aux

    def decode(self, h, cache, pos):
        """Single-token decode against this layer's cache, written in place."""
        hn = self.ln1(h, self.cfg.norm_eps)
        if self.cfg.mla is not None:
            a, _, _ = self.attn.decode(hn, cache["ckv"], cache["krope"], pos)
        else:
            a, _, _ = self.attn.decode(hn, cache["k"], cache["v"], pos)
        return self._ffn(h + a)[0]

    def prefill(self, h, positions):
        """Full-seq forward that also emits this layer's KV for the cache."""
        hn = self.ln1(h, self.cfg.norm_eps)
        if self.cfg.mla is not None:
            a, ckv, krope = self.attn(hn, positions, causal=True)
            kv = {"ckv": ckv, "krope": krope}
        else:
            a, k, v = self.attn.prefill(hn, positions)
            kv = {"k": k, "v": v}
        return self._ffn(h + a)[0], kv


def decoder_stack(blocks, h, positions, *, causal=True, remat="nothing"):
    """Returns (h, aux_sum)."""
    aux = torch.zeros((), device=h.device)
    for blk in blocks:
        h, a = maybe_remat(blk, remat)(h, positions, causal=causal)
        aux = aux + a
    return h, aux


def decoder_stack_decode(blocks, h, caches, pos):
    for i, blk in enumerate(blocks):
        with batch_sharded(_slice(caches, i)) as c:
            h = blk.decode(h, c, pos)
    return h, caches


def decoder_stack_prefill(blocks, h, positions):
    """Returns (h, the stacked per-layer KV: a dict of [L, ...])."""
    kvs = []
    for blk in blocks:
        h, kv = blk.prefill(h, positions)
        kvs.append(kv)
    return h, {k: torch.stack([kv[k] for kv in kvs]) for k in kvs[0]}


# ===========================================================================
# whisper encoder block (bidirectional, LayerNorm + GELU MLP)
# ===========================================================================
class EncoderBlock(L.Module):
    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = L.LayerNorm(cfg.d_model, device)
        self.attn = A.GQA(cfg, dtype, device)
        self.ln2 = L.LayerNorm(cfg.d_model, device)
        self.mlp = L.GeluMLP(cfg.d_model, cfg.d_ff, dtype, device)

    def forward(self, h, positions):
        eps = self.cfg.norm_eps
        h = h + self.attn(self.ln1(h, eps), positions, causal=False)
        return shard_activation(h + self.mlp(self.ln2(h, eps)), "hidden")


# ===========================================================================
# whisper decoder block (causal self-attn + cross-attn + GELU MLP)
# ===========================================================================
class XDecBlock(L.Module):
    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = L.LayerNorm(cfg.d_model, device)
        self.attn = A.GQA(cfg, dtype, device)
        self.ln_x = L.LayerNorm(cfg.d_model, device)
        self.xattn = A.CrossAttention(cfg, dtype, device)
        self.ln2 = L.LayerNorm(cfg.d_model, device)
        self.mlp = L.GeluMLP(cfg.d_model, cfg.d_ff, dtype, device)

    def forward(self, h, enc_out, positions):
        eps = self.cfg.norm_eps
        h = h + self.attn(self.ln1(h, eps), positions, causal=True)
        h = h + self.xattn(self.ln_x(h, eps), enc_out)
        return shard_activation(h + self.mlp(self.ln2(h, eps)), "hidden")

    def decode(self, h, cache, pos):
        """cache: {'k','v' (self, written in place), 'xk','xv' (frozen)}."""
        eps = self.cfg.norm_eps
        a, _, _ = self.attn.decode(self.ln1(h, eps), cache["k"], cache["v"],
                                   pos)
        h = h + a
        h = h + self.xattn.cached(self.ln_x(h, eps), cache["xk"], cache["xv"])
        return h + self.mlp(self.ln2(h, eps))


def xdec_cross_kv(blocks, enc_out):
    """Frozen cross-attention K/V of every decoder layer: two
    [L,B,Se,H,hd]."""
    kvs = [blk.xattn.kv(enc_out) for blk in blocks]
    return (torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs]))


# ===========================================================================
# xLSTM super-layer: (slstm_every - 1) mLSTM blocks + 1 sLSTM block
# ===========================================================================
class XLSTMSuper(L.Module):
    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        self.cfg = cfg
        n_m = cfg.xlstm.slstm_every - 1
        self.mlstm = nn.ModuleList(S.MLSTM(cfg, dtype, device)
                                   for _ in range(max(n_m, 1)))
        self.slstm = S.SLSTM(cfg, dtype, device)

    def forward(self, h):
        eps = self.cfg.norm_eps
        for pm in self.mlstm:
            h = h + pm(pm.norm(h, eps))
        return shard_activation(h + self.slstm(self.slstm.norm(h, eps)),
                                "hidden")

    def decode(self, h, state):
        eps = self.cfg.norm_eps
        for j, pm in enumerate(self.mlstm):
            d, _ = pm.decode(pm.norm(h, eps), _slice(state["mlstm"], j))
            h = h + d
        d, _ = self.slstm.decode(self.slstm.norm(h, eps), state["slstm"])
        return h + d


# ===========================================================================
# Zamba2 super-layer: k Mamba2 blocks + one *shared* attention block
# ===========================================================================
class ZambaShared(L.Module):
    """Shared attention+MLP block over concat(h, h_emb0) (Zamba design)."""

    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.resolved_head_dim
        self.ln = L.RMSNorm(2 * d, device)
        self.dense("wq", 2 * d, cfg.n_heads * hd, dtype, device)
        self.dense("wk", 2 * d, cfg.n_kv_heads * hd, dtype, device)
        self.dense("wv", 2 * d, cfg.n_kv_heads * hd, dtype, device)
        self.dense("wo", cfg.n_heads * hd, d, dtype, device)
        self.ln2 = L.RMSNorm(d, device)
        self.mlp = L.SwiGLU(d, cfg.d_ff, dtype, device)

    def _qkv(self, h, emb0, positions):
        cfg = self.cfg
        hcat = self.ln(torch.cat([h, emb0], dim=-1), cfg.norm_eps)
        b, s, _ = hcat.shape
        hd = cfg.resolved_head_dim
        q = L.heads(L.matmul(hcat, self.wq), cfg.n_heads, hd)
        k = L.heads(L.matmul(hcat, self.wk), cfg.n_kv_heads, hd)
        v = L.heads(L.matmul(hcat, self.wv), cfg.n_kv_heads, hd)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    def _out(self, h, o):
        h = h + L.matmul(o.reshape(*h.shape[:2], -1), self.wo)
        return h + self.mlp(self.ln2(h, self.cfg.norm_eps))

    def forward(self, h, emb0, positions):
        n_rep = self.cfg.n_heads // self.cfg.n_kv_heads
        q, k, v = self._qkv(h, emb0, positions)
        o = A.attention(q, A._expand_kv(k, n_rep), A._expand_kv(v, n_rep),
                        causal=True)
        return self._out(h, o)

    def decode(self, h, emb0, k_cache, v_cache, pos):
        posv = torch.full((h.shape[0], 1), pos, device=h.device)
        q, k, v = self._qkv(h, emb0, posv)
        A._write(k_cache, k, pos)
        A._write(v_cache, v, pos)
        return self._out(h, A.decode_attention(q, k_cache, v_cache, pos))


class ZambaMamba(L.Module):
    """One pre-normed Mamba2 layer of a Zamba super-layer."""

    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        self.norm = L.RMSNorm(cfg.d_model, device)
        self.m = S.Mamba2(cfg, dtype, device)


class ZambaSuper(L.Module):
    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        self.cfg = cfg
        self.mamba = nn.ModuleList(ZambaMamba(cfg, dtype, device)
                                   for _ in range(cfg.shared_attn_every))

    def forward(self, h, shared, emb0, positions):
        for pm in self.mamba:
            h = h + pm.m(pm.norm(h, self.cfg.norm_eps))
        return shard_activation(shared(h, emb0, positions), "hidden")

    def decode(self, h, shared, emb0, state, pos):
        for j, pm in enumerate(self.mamba):
            d, _ = pm.m.decode(pm.norm(h, self.cfg.norm_eps),
                               _slice(state["mamba"], j))
            h = h + d
        return shared.decode(h, emb0, state["k"], state["v"], pos)
