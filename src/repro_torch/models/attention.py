"""Attention variants: GQA (with optional QKV bias), MLA (DeepSeek-V3),
cross-attention, and KV-cache decode paths (port of
``repro.models.attention``).

Two attention algorithms, as in the reference:

* ``attention_einsum`` materializes the [B,H,S,S] fp32 score matrix;
* ``attention_online`` is the online softmax over KV chunks, a Python loop
  where the reference scans, with O(S · chunk) live scores.

``attention`` takes the online form from ``ONLINE_ATTN_MIN_SEQ`` keys up.
Scores, softmax and the online accumulators stay fp32 throughout; masked
scores are ``NEG_INF = -1e30``, not ``-inf``.  Decode paths write the new
K/V (or MLA latent) into the cache tensors they are given, in place.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.distributed.sharding import batch_local
from repro_torch.models import layers as L

NEG_INF = -1e30
ONLINE_ATTN_MIN_SEQ = 4096   # use online-softmax attention at/above this length


# ---------------------------------------------------------------------------
# core attention algorithms
# ---------------------------------------------------------------------------
def _expand_kv(k, n_rep):
    """[B,S,KVH,hd] -> [B,S,KVH*n_rep,hd]: query head h reads KV head
    h // n_rep (GQA)."""
    if n_rep == 1:
        return k
    b, s, kvh, d = k.shape
    # an expand and a copy (``repeat_interleave`` of a DTensor decomposes
    # into a data-dependent op that a fake tensor cannot trace)
    return k[:, :, :, None, :].expand(b, s, kvh, n_rep, d).reshape(
        b, s, kvh * n_rep, d)


def _heads_first(t):
    """[B,S,H,d] -> [B*H, S, d]."""
    b, s, h, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(b * h, s, d)


def attention_einsum(q, k, v, *, causal, q_offset=0):
    """q: [B,Sq,H,hd]; k,v: [B,Sk,H,hd].  Returns [B,Sq,H,hd_v]."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    # bf16 products are exact in fp32, so upcasting q and k (activations,
    # not weights) gives the reference's fp32-accumulated scores
    scores = torch.bmm(_heads_first(q.float()),
                       _heads_first(k.float()).transpose(1, 2))
    scores = (scores / math.sqrt(hd)).view(b, h, sq, sk)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(sk, device=q.device)[None, :]
        scores = scores.masked_fill(qpos < kpos, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = L.bmatmul(probs.to(v.dtype).view(b * h, sq, sk), _heads_first(v))
    return out.view(b, h, sq, -1).permute(0, 2, 1, 3).to(q.dtype)


def attention_online(q, k, v, *, causal, q_offset=0, chunk=1024):
    """Online-softmax attention over KV chunks (a Python loop).

    Peak live memory is the fp32 accumulator plus one [B,H,Sq,chunk] score
    block.  A chunk that does not divide the keys falls back to their gcd.
    """
    b, sq, h, hd = q.shape
    hd_v = v.shape[-1]                 # may differ from q/k (MLA)
    sk = k.shape[1]
    if sk % chunk != 0:
        chunk = math.gcd(sk, chunk) or sk
    n_chunks = sk // chunk
    qf = _heads_first(q.float() / math.sqrt(hd))           # [B*H, Sq, hd]
    kf = _heads_first(k.float())
    vf = _heads_first(v.float())
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    acc = torch.zeros((b * h, sq, hd_v), dtype=torch.float32, device=q.device)
    m = torch.full((b * h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b * h, sq), dtype=torch.float32, device=q.device)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        s = torch.bmm(qf, kf[:, sl].transpose(1, 2))        # [B*H, Sq, chunk]
        if causal:
            kpos = i * chunk + torch.arange(chunk, device=q.device)[None, :]
            s = s.masked_fill(qpos < kpos, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        scale = torch.exp(m - m_new)
        l = l * scale + p.sum(dim=-1)
        acc = acc * scale[..., None] + torch.bmm(p, vf[:, sl])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.view(b, h, sq, hd_v).permute(0, 2, 1, 3).to(q.dtype)


def attention(q, k, v, *, causal, q_offset=0):
    """On a mesh, each rank attends its own (batch, head) blocks."""
    fn = attention_online if k.shape[1] >= ONLINE_ATTN_MIN_SEQ \
        else attention_einsum
    return batch_local(functools.partial(fn, causal=causal,
                                         q_offset=q_offset),
                       q, k, v, dims=(0, 2))


def decode_attention(q, k_cache, v_cache, pos):
    """Single-token decode: q [B,1,H,hd] vs cache [B,Smax,KVH,hd].

    Every slot is read; slots past ``pos`` are masked (the cache may be
    partially filled), so the cost follows the cache's size.  On a mesh,
    each rank attends its own batch rows.
    """
    return batch_local(functools.partial(_decode_attention, pos=pos),
                       q, k_cache, v_cache)


def _decode_attention(q, k_cache, v_cache, pos):
    b, smax, kvh, hd = k_cache.shape
    h = q.shape[2]
    k = _expand_kv(k_cache, h // kvh)
    v = _expand_kv(v_cache, h // kvh)
    qf = _heads_first(q.float() / math.sqrt(hd))           # [B*H, 1, hd]
    s = torch.bmm(qf, _heads_first(k.float()).transpose(1, 2))
    s = s.masked_fill(torch.arange(smax, device=q.device) > pos, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.bmm(p, _heads_first(v.float()))            # [B*H, 1, hd]
    return out.view(b, h, 1, -1).permute(0, 2, 1, 3).to(q.dtype)


def _write(cache, new, pos):
    """cache[:, pos:pos+S] = new, in place; returns cache."""
    cache[:, pos:pos + new.shape[1]] = new.to(cache.dtype)
    return cache


# ---------------------------------------------------------------------------
# GQA projection block
# ---------------------------------------------------------------------------
class GQA(L.Module):
    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        self.cfg = cfg
        hd = cfg.resolved_head_dim
        self.dense("wq", cfg.d_model, cfg.n_heads * hd, dtype, device)
        self.dense("wk", cfg.d_model, cfg.n_kv_heads * hd, dtype, device)
        self.dense("wv", cfg.d_model, cfg.n_kv_heads * hd, dtype, device)
        self.dense("wo", cfg.n_heads * hd, cfg.d_model, dtype, device)
        if cfg.qkv_bias:
            self.param("bq", (cfg.n_heads * hd,), dtype, device, "zeros")
            self.param("bk", (cfg.n_kv_heads * hd,), dtype, device, "zeros")
            self.param("bv", (cfg.n_kv_heads * hd,), dtype, device, "zeros")

    def project_qkv(self, x, positions):
        """q [B,S,H,hd], k/v [B,S,KVH,hd], with RoPE applied if enabled."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.resolved_head_dim
        q = L.matmul(x, self.wq)
        k = L.matmul(x, self.wk)
        v = L.matmul(x, self.wv)
        if cfg.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q = L.heads(q, cfg.n_heads, hd)
        k = L.heads(k, cfg.n_kv_heads, hd)
        v = L.heads(v, cfg.n_kv_heads, hd)
        if cfg.rope_theta:
            q = L.apply_rope(q, positions, cfg.rope_theta)
            k = L.apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    def _attend(self, q, k, v, causal):
        n_rep = self.cfg.n_heads // self.cfg.n_kv_heads
        o = attention(q, _expand_kv(k, n_rep), _expand_kv(v, n_rep),
                      causal=causal)
        return L.matmul(o.reshape(*q.shape[:2], -1), self.wo)

    def forward(self, x, positions, *, causal=True):
        """Full-sequence GQA self-attention (train / prefill)."""
        q, k, v = self.project_qkv(x, positions)
        return self._attend(q, k, v, causal)

    def prefill(self, x, positions):
        """Attention output plus the K/V tensors for cache population."""
        q, k, v = self.project_qkv(x, positions)
        return self._attend(q, k, v, True), k, v

    def decode(self, x, k_cache, v_cache, pos):
        """x: [B,1,D].  Writes the cache at ``pos`` in place; returns
        (out, k_cache, v_cache)."""
        b = x.shape[0]
        posv = torch.full((b, 1), pos, device=x.device)
        q, k, v = self.project_qkv(x, posv)
        _write(k_cache, k, pos)
        _write(v_cache, v, pos)
        o = decode_attention(q, k_cache, v_cache, pos)
        return L.matmul(o.reshape(b, 1, -1), self.wo), k_cache, v_cache


# ---------------------------------------------------------------------------
# cross-attention (whisper decoder)
# ---------------------------------------------------------------------------
class CrossAttention(L.Module):
    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        self.cfg = cfg
        hd = cfg.resolved_head_dim
        for name in ("wq", "wk", "wv"):
            self.dense(name, cfg.d_model, cfg.n_heads * hd, dtype, device)
        self.dense("wo", cfg.n_heads * hd, cfg.d_model, dtype, device)

    def kv(self, enc_out):
        """The frozen K/V of ``enc_out``: two [B,Se,H,hd]."""
        b, se, _ = enc_out.shape
        hd = self.cfg.resolved_head_dim
        k = L.heads(L.matmul(enc_out, self.wk), self.cfg.n_heads, hd)
        v = L.heads(L.matmul(enc_out, self.wv), self.cfg.n_heads, hd)
        return k, v

    def forward(self, x, enc_out):
        return self.cached(x, *self.kv(enc_out))

    def cached(self, x, k, v):
        """Decode-time cross attention against a precomputed K/V."""
        b, s, _ = x.shape
        hd = self.cfg.resolved_head_dim
        q = L.heads(L.matmul(x, self.wq), self.cfg.n_heads, hd)
        o = attention(q, k, v, causal=False)
        return L.matmul(o.reshape(b, s, -1), self.wo)


# ---------------------------------------------------------------------------
# MLA — DeepSeek-V3 Multi-head Latent Attention
# ---------------------------------------------------------------------------
class MLA(L.Module):
    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        self.cfg = cfg
        m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
        qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
        self.dense("wdq", d, m.q_lora_rank, dtype, device)
        self.q_norm = L.RMSNorm(m.q_lora_rank, device)
        self.dense("wuq", m.q_lora_rank, h * qk_head, dtype, device)
        self.dense("wdkv", d, m.kv_lora_rank, dtype, device)
        self.kv_norm = L.RMSNorm(m.kv_lora_rank, device)
        self.dense("wuk", m.kv_lora_rank, h * m.qk_nope_head_dim, dtype,
                   device)
        self.dense("wuv", m.kv_lora_rank, h * m.v_head_dim, dtype, device)
        self.dense("wkr", d, m.qk_rope_head_dim, dtype, device)
        self.dense("wo", h * m.v_head_dim, d, dtype, device)

    def _q(self, x, positions):
        cfg, m = self.cfg, self.cfg.mla
        b, s, _ = x.shape
        cq = self.q_norm(L.matmul(x, self.wdq), cfg.norm_eps)
        q = L.matmul(cq, self.wuq).view(
            b, s, cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
        q_nope = q[..., :m.qk_nope_head_dim]
        q_rope = L.apply_rope(q[..., m.qk_nope_head_dim:], positions,
                              cfg.rope_theta)
        return q_nope, q_rope

    def _latent(self, x, positions):
        """Compressed KV latent c_kv [B,S,r] and shared rope key [B,S,rd]."""
        cfg = self.cfg
        c_kv = self.kv_norm(L.matmul(x, self.wdkv), cfg.norm_eps)
        k_rope = L.matmul(x, self.wkr)[:, :, None, :]         # [B,S,1,rd]
        k_rope = L.apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0]
        return c_kv, k_rope

    def forward(self, x, positions, *, causal=True):
        """Naive (expanded) MLA for train/prefill: decompress K/V per
        position.  Returns (out, c_kv, k_rope)."""
        cfg, m = self.cfg, self.cfg.mla
        b, s, _ = x.shape
        h = cfg.n_heads
        q_nope, q_rope = self._q(x, positions)
        c_kv, k_rope = self._latent(x, positions)
        k_nope = L.heads(L.matmul(c_kv, self.wuk), h, m.qk_nope_head_dim)
        v = L.heads(L.matmul(c_kv, self.wuv), h, m.v_head_dim)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            b, s, h, m.qk_rope_head_dim)], dim=-1)
        o = attention(q, k, v, causal=causal)
        return L.matmul(o.reshape(b, s, -1), self.wo), c_kv, k_rope

    def decode(self, x, ckv_cache, krope_cache, pos):
        """Weight-absorbed MLA decode: attention runs in the latent space,
        ``wuk`` absorbed into the query and ``wuv`` into the output, so the
        cache stays [B,S,kv_lora_rank] + [B,S,rope_d]."""
        cfg, m = self.cfg, self.cfg.mla
        b = x.shape[0]
        h, r = cfg.n_heads, m.kv_lora_rank
        posv = torch.full((b, 1), pos, device=x.device)
        q_nope, q_rope = self._q(x, posv)                      # [B,1,H,*]
        c_kv, k_rope = self._latent(x, posv)                   # [B,1,r], [B,1,rd]
        _write(ckv_cache, c_kv, pos)
        _write(krope_cache, k_rope, pos)
        # absorb W_uk: q_lat[b,h,r] = sum_n q_nope[b,h,n] W_uk[r,h,n], fp32
        wuk = self.wuk.view(r, h, m.qk_nope_head_dim).permute(1, 2, 0)
        q_lat = L.bmatmul_f32(q_nope[:, 0].transpose(0, 1).contiguous(),
                              wuk)                             # [H,B,r]
        scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
        ckv = ckv_cache.float()                                # [B,S,r]
        s_lat = torch.bmm(q_lat.transpose(0, 1), ckv.transpose(1, 2))
        s_rope = torch.bmm(q_rope[:, 0].float(),
                           krope_cache.float().transpose(1, 2))  # [B,H,S]
        s = (s_lat + s_rope) * scale
        probs = torch.softmax(s.masked_fill(
            torch.arange(ckv_cache.shape[1], device=x.device) > pos, NEG_INF),
            dim=-1)
        o_lat = torch.bmm(probs, ckv)                          # [B,H,r]
        # the reference promotes wuv to fp32 against the fp32 latent output
        wuv = self.wuv.view(r, h, m.v_head_dim).permute(1, 0, 2).float()
        o = torch.bmm(o_lat.transpose(0, 1), wuv).transpose(0, 1)  # [B,H,v]
        o = o.to(x.dtype).reshape(b, 1, -1)
        return L.matmul(o, self.wo), ckv_cache, krope_cache
