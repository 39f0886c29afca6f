"""State-space / recurrent blocks: Mamba2 (SSD) and xLSTM (mLSTM + sLSTM)
(port of ``repro.models.ssm``).

Every block has a full-sequence form (``forward``: a chunked parallel scan,
a Python loop over chunks where the reference scans), a single-token
``decode`` against a carried state, and ``init_state``.  ``decode`` writes
the new state into the state tensors it is given, in place, and returns
them.  On a mesh the scans and recurrent steps run on each rank's batch
rows (``sharding.batch_local``).  Softplus is ``logaddexp(x, 0)``
(``jax.nn.softplus``, with no threshold), and log-sigmoid is
``-softplus(-x)``.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import batch_local
from repro_torch.models import layers as L


def softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _silu_as(x, dtype):
    return F.silu(x.float()).to(dtype)


class Conv(L.Module):
    """Depthwise causal conv weights: ``w`` [K, C], ``b`` [C]."""

    def __init__(self, k, c, dtype, device=None):
        super().__init__()
        self.param("w", (k, c), dtype, device, 1.0 / np.sqrt(k))
        self.param("b", (c,), dtype, device, "zeros")


def _causal_conv(xbc, w, b):
    """Depthwise causal conv, kernel K: xbc [B,S,C], w [K,C]."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + s, :] * w[i] for i in range(k))
    return _silu_as(out + b, xbc.dtype)


def _conv_step(conv_state, new, w, b, dtype):
    """One causal-conv step: window = [state | new] (promoted to the wider
    dtype, as the reference's concatenate); returns (silu(conv) in
    ``dtype``, window)."""
    win = torch.cat([conv_state, new[:, None, :]], dim=1)
    out = (win * w[None]).sum(dim=1) + b
    return _silu_as(out, dtype), win


# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================
def mamba2_dims(cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    return d_inner, n_heads


class Mamba2(L.Module):
    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        self.cfg = cfg
        s = cfg.ssm
        d_inner, n_heads = mamba2_dims(cfg)
        d_xbc = d_inner + 2 * s.d_state          # x stream + B + C (1 group)
        # fused input projection: [z | xBC | dt]
        self.dense("in_proj", cfg.d_model, d_inner + d_xbc + n_heads, dtype,
                   device)
        self.conv = Conv(s.d_conv, d_xbc, dtype, device)
        f32 = torch.float32
        self.param("A_log", (n_heads,), f32, device,
                   np.log(np.linspace(1.0, 16.0, n_heads, dtype=np.float32)))
        self.param("D", (n_heads,), f32, device, "ones")
        # the reference's log(expm1(...)) in float32; carried across from the
        # reference by the converter, never recomputed for a comparison
        self.param("dt_bias", (n_heads,), f32, device,
                   np.log(np.expm1(np.linspace(1e-3, 1e-1, n_heads,
                                               dtype=np.float32))))
        self.norm = L.RMSNorm(d_inner, device)
        self.dense("out_proj", d_inner, cfg.d_model, dtype, device)

    def forward(self, x):
        return mamba2_apply(self, self.cfg, x)

    def decode(self, x, state):
        return mamba2_decode(self, self.cfg, x, state)


def _ssd_chunked(x, dt, A, B, C, chunk):
    """Chunked SSD scan: quadratic-in-chunk work inside a chunk, the
    running state [B,H,P,N] carried between chunks.

    x [B,S,H,P]; dt [B,S,H] (positive); A [H] (negative rates);
    B,C [B,S,N] (single group, broadcast over heads).  Returns y [B,S,H,P].
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = chunk
    xf, Bf, Cf = x.float(), B.float(), C.float()
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    # the chunks as ``split``'s slices: its backward is one concatenation,
    # where a slice taken by indexing would add a full-size gradient a chunk
    for xb, dtb, Bb, Cb in zip(*(t.split(q, dim=1)
                                 for t in (xf, dt, Bf, Cf))):
        dA = dtb * A                                        # [B,Q,H]
        cum = torch.cumsum(dA, dim=1)
        xdt = xb * dtb[..., None]
        # intra-chunk: L[i,j] = exp(cum_i - cum_j), j <= i.  Masked before
        # the exp (to -inf, whose exp is the same 0): above the diagonal
        # li grows with i - j, and an exp that overflows to inf would send
        # 0 * inf = NaN into the gradient, as the reference's masking after
        # the exp does (src/repro/models/ssm.py:92)
        li = cum[:, :, None, :] - cum[:, None, :, :]        # [B,Q,Q,H]
        decay = torch.exp(li.masked_fill(~mask[None, :, :, None],
                                         -float("inf")))
        cb = torch.einsum("bin,bjn->bij", Cb, Bb)
        y_intra = torch.einsum("bij,bijh,bjhp->bihp", cb, decay, xdt)
        # inter-chunk from carried state
        y_inter = torch.einsum("bin,bih,bhpn->bihp", Cb, torch.exp(cum), state)
        # state update
        seg = torch.exp(cum[:, -1:, :] - cum)               # [B,Q,H]
        upd = torch.einsum("bjn,bjh,bjhp->bhpn", Bb, seg, xdt)
        state = state * torch.exp(cum[:, -1, :])[:, :, None, None] + upd
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1)


def _split_xbc(cfg, zxbcdt):
    d_inner, _ = mamba2_dims(cfg)
    d_xbc = d_inner + 2 * cfg.ssm.d_state
    return torch.split(zxbcdt, [d_inner, d_xbc, zxbcdt.shape[-1]
                                - d_inner - d_xbc], dim=-1)


def mamba2_apply(p, cfg, x):
    """x [B,S,d] -> [B,S,d]; full-sequence chunked SSD."""
    s_cfg = cfg.ssm
    b, s, d = x.shape
    d_inner, n_heads = mamba2_dims(cfg)
    z, xbc, dt_raw = _split_xbc(cfg, L.matmul(x, p.in_proj))
    xbc = _causal_conv(xbc, p.conv.w, p.conv.b)
    xs, B, C = torch.split(xbc, [d_inner, s_cfg.d_state, s_cfg.d_state],
                           dim=-1)
    xs = L.heads(xs, n_heads, s_cfg.head_dim)
    dt = softplus(dt_raw.float() + p.dt_bias)
    A = -torch.exp(p.A_log)
    chunk = min(s_cfg.chunk_size, s)
    if s % chunk:
        chunk = math.gcd(s, chunk) or 1
    y = batch_local(functools.partial(_ssd_chunked, chunk=chunk),
                    xs, dt, A, B, C)
    y = y + xs.float() * p.D[None, None, :, None]
    y = y.reshape(b, s, d_inner).to(x.dtype)
    y = y * _silu_as(z, x.dtype)
    y = p.norm(y, cfg.norm_eps)
    return L.matmul(y, p.out_proj)


def mamba2_init_state(cfg, batch, dtype=torch.float32, device=None):
    s = cfg.ssm
    d_inner, n_heads = mamba2_dims(cfg)
    d_xbc = d_inner + 2 * s.d_state
    return {
        "ssm": torch.zeros((batch, n_heads, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.d_conv - 1, d_xbc), dtype=dtype,
                            device=device),
    }


def _ssd_step(xs, B, C, dt, ssm, A, D):
    """One recurrent SSD step: (y [B,H,P], the new state [B,H,P,N])."""
    decay = torch.exp(dt * A)                               # [B,H]
    upd = torch.einsum("bhp,bn,bh->bhpn", xs, B.float(), dt)
    ssm = ssm * decay[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", ssm, C.float()) + xs * D[None, :, None]
    return y, ssm


def mamba2_decode(p, cfg, x, state):
    """x [B,1,d]; recurrent single-step update of ``state`` in place."""
    s_cfg = cfg.ssm
    b = x.shape[0]
    d_inner, n_heads = mamba2_dims(cfg)
    z, xbc, dt_raw = _split_xbc(cfg, L.matmul(x, p.in_proj)[:, 0])
    xbc_c, win = _conv_step(state["conv"], xbc, p.conv.w, p.conv.b, x.dtype)
    xs, B, C = torch.split(xbc_c, [d_inner, s_cfg.d_state, s_cfg.d_state],
                           dim=-1)
    xs = L.heads(xs, n_heads, s_cfg.head_dim).float()
    dt = softplus(dt_raw.float() + p.dt_bias)               # [B,H]
    A = -torch.exp(p.A_log)
    y, ssm = batch_local(_ssd_step, xs, B, C, dt, state["ssm"], A, p.D)
    y = y.reshape(b, 1, d_inner).to(x.dtype)
    y = y * _silu_as(z, x.dtype)[:, None, :]
    y = p.norm(y, cfg.norm_eps)
    state["ssm"].copy_(ssm)
    state["conv"].copy_(win[:, 1:, :])
    return L.matmul(y, p.out_proj), state


# ===========================================================================
# mLSTM (xLSTM matrix-memory block)
# ===========================================================================
def mlstm_dims(cfg):
    d_up = int(cfg.xlstm.proj_factor * cfg.d_model)
    n_heads = cfg.n_heads
    head_dim = d_up // n_heads
    return d_up, n_heads, head_dim


class MLSTM(L.Module):
    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        d_up, n_heads, _ = mlstm_dims(cfg)
        self.norm = L.RMSNorm(d, device)
        self.dense("up_proj", d, 2 * d_up, dtype, device)     # [u | z]
        self.conv = Conv(cfg.xlstm.conv_kernel, d_up, dtype, device)
        self.dense("wq", d_up, d_up, dtype, device)
        self.dense("wk", d_up, d_up, dtype, device)
        self.dense("wv", d_up, d_up, dtype, device)
        self.param("w_gates", (d_up, 2 * n_heads), torch.float32, device,
                   1.0 / np.sqrt(d_up))
        self.param("b_gates", (2 * n_heads,), torch.float32, device,
                   np.concatenate([np.linspace(3.0, 6.0, n_heads,   # forget
                                               dtype=np.float32),
                                   np.zeros(n_heads, np.float32)]))  # input
        self.out_norm = L.RMSNorm(d_up, device)
        self.dense("down_proj", d_up, d, dtype, device)

    def forward(self, x):
        return mlstm_apply(self, self.cfg, x)

    def decode(self, x, state):
        return mlstm_decode(self, self.cfg, x, state)


def _mlstm_chunked(q, k, v, log_f, log_i, chunk):
    """Stabilized chunkwise-parallel mLSTM (a loop over chunks).

    q,k,v: [B,S,H,P]; log_f/log_i: [B,S,H].  Returns h [B,S,H,P].
    Within a chunk D[i,j] = exp(cumF_i - cumF_j + log_i_j - m_i), j <= i;
    across chunks the state (C, n) is carried with its own stabilizer m_run.
    """
    b, s, h, p = q.shape
    Q = chunk
    qf, kf, vf = q.float(), k.float(), v.float()
    lff, lif = log_f.float(), log_i.float()
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=q.device))
    C = torch.zeros((b, h, p, p), dtype=torch.float32, device=q.device)
    nvec = torch.zeros((b, h, p), dtype=torch.float32, device=q.device)
    m_run = torch.zeros((b, h), dtype=torch.float32, device=q.device)
    ys = []
    # the chunks as ``split``'s slices, as `_ssd_chunked` takes them
    for qb, kb, vb, lf, li in zip(*(t.split(Q, dim=1)
                                    for t in (qf, kf, vf, lff, lif))):
        cumf = torch.cumsum(lf, dim=1)                       # [B,Q,H]
        logd = cumf[:, :, None, :] - cumf[:, None, :, :] + li[:, None, :, :]
        logd = logd.masked_fill(~mask[None, :, :, None], -1e30)
        inter_log = m_run[:, None, :] + cumf                 # [B,Q,H]
        m_i = torch.maximum(logd.amax(dim=2), inter_log)
        d = torch.exp(logd - m_i[:, :, None, :])
        qk = torch.einsum("bihp,bjhp->bijh", qb, kb) / math.sqrt(p)
        w = qk * d
        num = torch.einsum("bijh,bjhp->bihp", w, vb)
        den = w.sum(dim=2)                                   # [B,Q,H]
        # carried-state contribution
        scale = torch.exp(inter_log - m_i)                   # [B,Q,H]
        num = num + torch.einsum("bihq,bhpq,bih->bihp", qb, C, scale)
        den = den + torch.einsum("bihq,bhq,bih->bih", qb, nvec, scale)
        ys.append(num / torch.maximum(den.abs(), torch.exp(-m_i))[..., None])
        # state update to end of chunk
        tot = cumf[:, -1, :]                                 # [B,H]
        e_j = li + tot[:, None, :] - cumf                    # decay j -> end
        m_new = torch.maximum(m_run + tot, e_j.amax(dim=1))
        sj = torch.exp(e_j - m_new[:, None, :])
        k_s = kb / math.sqrt(p)
        carry = torch.exp(m_run + tot - m_new)
        C = C * carry[:, :, None, None] + \
            torch.einsum("bjh,bjhp,bjhq->bhpq", sj, vb, k_s)
        nvec = nvec * carry[:, :, None] + \
            torch.einsum("bjh,bjhq->bhq", sj, k_s)
        m_run = m_new
    return torch.cat(ys, dim=1)


def mlstm_apply(p, cfg, x):
    """Full-sequence mLSTM block (pre-norm residual handled by caller)."""
    b, s, d = x.shape
    d_up, n_heads, head_dim = mlstm_dims(cfg)
    u, z = L.matmul(x, p.up_proj).chunk(2, dim=-1)
    uc = _causal_conv(u, p.conv.w, p.conv.b)
    q = L.heads(L.matmul(uc, p.wq), n_heads, head_dim)
    k = L.heads(L.matmul(uc, p.wk), n_heads, head_dim)
    v = L.heads(L.matmul(u, p.wv), n_heads, head_dim)
    gates = uc.float() @ p.w_gates + p.b_gates
    f_pre, i_pre = gates.chunk(2, dim=-1)                   # [B,S,H]
    log_f = -softplus(-f_pre)                               # log sigmoid
    chunk = min(256, s)
    if s % chunk:
        chunk = math.gcd(s, chunk) or 1
    hidden = batch_local(functools.partial(_mlstm_chunked, chunk=chunk),
                         q, k, v, log_f, i_pre)
    hidden = hidden.reshape(b, s, d_up).to(x.dtype)
    hidden = p.out_norm(hidden, cfg.norm_eps)
    hidden = hidden * _silu_as(z, x.dtype)
    return L.matmul(hidden, p.down_proj)


def mlstm_init_state(cfg, batch, device=None):
    d_up, n_heads, head_dim = mlstm_dims(cfg)
    f32 = torch.float32
    return {
        "C": torch.zeros((batch, n_heads, head_dim, head_dim), dtype=f32,
                         device=device),
        "n": torch.zeros((batch, n_heads, head_dim), dtype=f32, device=device),
        # m starts at 0 (not -inf), as the chunked form's stabilizer
        "m": torch.zeros((batch, n_heads), dtype=f32, device=device),
        # the reference keeps the conv window in bf16 whatever the model's
        # dtype
        "conv": torch.zeros((batch, cfg.xlstm.conv_kernel - 1, d_up),
                            dtype=torch.bfloat16, device=device),
    }


def _mlstm_step(q, k, v, log_f, log_i, C, nvec, m):
    """One stabilized recurrent mLSTM step: (h [B,H,P], C, n, m)."""
    m_new = torch.maximum(log_f + m, log_i)
    f_s = torch.exp(log_f + m - m_new)                      # stabilized gates
    i_s = torch.exp(log_i - m_new)
    k_scaled = k / math.sqrt(q.shape[-1])
    C = C * f_s[..., None, None] + \
        i_s[..., None, None] * torch.einsum("bhp,bhq->bhpq", v, k_scaled)
    nvec = nvec * f_s[..., None] + i_s[..., None] * k_scaled
    num = torch.einsum("bhpq,bhq->bhp", C, q)
    den = torch.maximum(torch.einsum("bhq,bhq->bh", nvec, q).abs(),
                        torch.exp(-m_new))
    return num / den[..., None], C, nvec, m_new


def mlstm_decode(p, cfg, x, state):
    """x [B,1,d]; stabilized recurrent step, ``state`` updated in place."""
    b = x.shape[0]
    d_up, n_heads, head_dim = mlstm_dims(cfg)
    u, z = L.matmul(x, p.up_proj)[:, 0].chunk(2, dim=-1)
    uc, win = _conv_step(state["conv"].to(u.dtype), u, p.conv.w, p.conv.b,
                         x.dtype)
    q = L.heads(L.matmul(uc, p.wq), n_heads, head_dim).float()
    k = L.heads(L.matmul(uc, p.wk), n_heads, head_dim).float()
    v = L.heads(L.matmul(u, p.wv), n_heads, head_dim).float()
    gates = uc.float() @ p.w_gates + p.b_gates
    f_pre, log_i = gates.chunk(2, dim=-1)                   # [B,H]
    log_f = -softplus(-f_pre)
    h, C, nvec, m_new = batch_local(_mlstm_step, q, k, v, log_f, log_i,
                                    state["C"], state["n"], state["m"])
    h = h.reshape(b, 1, d_up).to(x.dtype)
    h = p.out_norm(h, cfg.norm_eps)
    h = h * _silu_as(z, x.dtype)[:, None, :]
    out = L.matmul(h, p.down_proj)
    state["C"].copy_(C)
    state["n"].copy_(nvec)
    state["m"].copy_(m_new)
    state["conv"].copy_(win[:, 1:, :].to(torch.bfloat16))
    return out, state


# ===========================================================================
# sLSTM (xLSTM scalar-memory block): a sequential cell
# ===========================================================================
class SLSTM(L.Module):
    def __init__(self, cfg, dtype, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        d_ff = int(4.0 / 3.0 * 2 * d)
        self.norm = L.RMSNorm(d, device)
        self.param("w", (d, 4 * d), torch.float32, device, 1.0 / np.sqrt(d))
        self.param("r", (d, 4 * d), torch.float32, device, 1.0 / np.sqrt(d))
        self.param("b", (4 * d,), torch.float32, device, "zeros")
        self.out_norm = L.RMSNorm(d, device)
        self.mlp = L.SwiGLU(d, d_ff, dtype, device)
        self.mlp_norm = L.RMSNorm(d, device)

    def forward(self, x):
        return slstm_apply(self, self.cfg, x)

    def decode(self, x, state):
        return slstm_decode(self, self.cfg, x, state)


def slstm_init_state(cfg, batch, device=None):
    d = cfg.d_model
    z = lambda: torch.zeros((batch, d), dtype=torch.float32, device=device)
    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full((batch, d), -math.inf, dtype=torch.float32,
                            device=device)}


def _slstm_cell(w, r, bias, x_t, st):
    """One sLSTM step.  x_t [B,d] fp32; state dict of [B,d]."""
    pre = x_t @ w + st["h"] @ r + bias
    z_pre, i_pre, f_pre, o_pre = pre.chunk(4, dim=-1)
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    log_f = -softplus(-f_pre)
    m_new = torch.maximum(log_f + st["m"], i_pre)
    i_s = torch.exp(i_pre - m_new)
    f_s = torch.exp(log_f + st["m"] - m_new)
    c = f_s * st["c"] + i_s * z
    n = torch.clamp(f_s * st["n"] + i_s, min=1e-6)
    h = o * (c / n)
    return {"c": c, "n": n, "h": h, "m": m_new}


def _slstm_out(p, cfg, h):
    h = p.out_norm(h, cfg.norm_eps)
    # post-MLP (the sLSTM block carries its own small FFN)
    return h + L.swiglu(p.mlp, p.mlp_norm(h, cfg.norm_eps))


def _slstm_scan(xf, w, r, bias, cfg):
    """The sLSTM's time loop over xf [B,S,d] fp32: the hidden states
    [B,S,d].  The steps take ``unbind``'s slices, whose backward is one
    stack: a slice taken by indexing would add a full-size gradient a
    step."""
    st = slstm_init_state(cfg, xf.shape[0], xf.device)
    hs = []
    for x_t in xf.unbind(1):
        st = _slstm_cell(w, r, bias, x_t, st)
        hs.append(st["h"])
    return torch.stack(hs, dim=1)


def slstm_apply(p, cfg, x):
    """x [B,S,d]; sequential over time (sLSTM is not parallelizable), on
    each rank's own rows."""
    h = batch_local(functools.partial(_slstm_scan, cfg=cfg), x.float(),
                    p.w, p.r, p.b)
    return _slstm_out(p, cfg, h.to(x.dtype))


def slstm_decode(p, cfg, x, state):
    st = _slstm_cell(p.w, p.r, p.b, x[:, 0].float(), state)
    for name, t in st.items():
        state[name].copy_(t)
    return _slstm_out(p, cfg, st["h"][:, None, :].to(x.dtype)), state
