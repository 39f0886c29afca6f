"""Primitive layers: norms, projections, RoPE, MLPs, embeddings (port of
``repro.models.layers``).

Weights keep the reference's layouts (``[in, out]`` projections, ``[vocab,
d]`` tables), so the reference's parameters carry across unchanged
(``convert.lm_params_from_reference``).  Compute runs in the config dtype
with fp32 accumulation on every matmul, rounded once to the activation
dtype; norms, softmax and logits run in fp32.  On the card a bf16 GEMM
accumulates in fp32 and rounds once, as the reference's
``preferred_element_type`` does; on the CPU both operands are upcast.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import is_dtensor
from repro_torch.models.analysis_flags import card_routes_active

INIT_SLAB = 1 << 26        # elements drawn at once by ``fill_``


# ---------------------------------------------------------------------------
# parameters with the reference's init rules
# ---------------------------------------------------------------------------
class Module(nn.Module):
    """An ``nn.Module`` whose parameters carry the reference's init rule:
    a float (a normal truncated to [-2, 2] times that scale), ``"ones"``,
    ``"zeros"`` or a numpy array.  Parameters are allocated empty on the
    module's device; ``init(generator)`` fills every one of them."""

    def __init__(self):
        super().__init__()
        self._rules = {}

    def param(self, name, shape, dtype, device, rule):
        p = nn.Parameter(torch.empty(shape, dtype=dtype, device=device))
        self.register_parameter(name, p)
        self._rules[name] = rule
        return p

    def dense(self, name, d_in, d_out, dtype, device):
        """A fan-in scaled ``[d_in, d_out]`` projection (``dense_init``)."""
        return self.param(name, (d_in, d_out), dtype, device,
                          1.0 / np.sqrt(d_in))

    def init(self, generator: torch.Generator):
        """Fill every parameter of this module and its children from
        ``generator`` (on the parameters' device); returns ``self``."""
        with torch.no_grad():
            for m in self.modules():
                for name, rule in getattr(m, "_rules", {}).items():
                    fill_(getattr(m, name), rule, generator)
        return self


def fill_(t: torch.Tensor, rule, generator: torch.Generator):
    if isinstance(rule, str):
        t.fill_(1.0 if rule == "ones" else 0.0)
    elif isinstance(rule, np.ndarray):
        t.copy_(torch.from_numpy(rule))
    else:
        # the reference draws in float32 and rounds to the weight's dtype;
        # draw slabs along dim 0 so a large bf16 weight needs no fp32 twin
        rows = t.view(t.shape[0], -1) if t.dim() > 1 else t.view(1, -1)
        step = max(1, INIT_SLAB // max(rows.shape[1], 1))
        for i in range(0, rows.shape[0], step):
            blk = torch.empty(rows[i:i + step].shape, dtype=torch.float32,
                              device=t.device)
            nn.init.trunc_normal_(blk, 0.0, 1.0, -2.0, 2.0,
                                  generator=generator)
            rows[i:i + step].copy_(blk * float(rule))


# ---------------------------------------------------------------------------
# matmuls
# ---------------------------------------------------------------------------
def _on_card(t) -> bool:
    """Whether ``t`` takes the card's GEMM routes: a CUDA tensor, or any
    under ``analysis_flags.card_routes`` (the dry run's fake tensors)."""
    return t.is_cuda or card_routes_active()


def matmul(x, w):
    """x @ w with fp32 accumulation, result in x.dtype (on DTensors,
    `_dtensor_mm`: a product summed over ranks is rounded once, after the
    sum)."""
    if x.dtype == w.dtype and (x.dtype == torch.float32 or _on_card(x)):
        return _dtensor_mm(x, w, torch.mm, x.dtype) if is_dtensor(x) \
            else x @ w
    if is_dtensor(x):
        return _dtensor_mm(x.float(), w.float(), torch.mm, x.dtype)
    return (x.float() @ w.float()).to(x.dtype)


def _f32_product(a, b):
    mm = torch.bmm if a.dim() == 3 else torch.mm
    if _on_card(a):
        return mm(a, b, out_dtype=torch.float32)
    return mm(a.float(), b.float())


class _Operands(torch.autograd.Function):
    """`MatmulF32`'s backward node: it saves ``a`` and ``b`` and returns a
    stand-in for the product ([.., M, N] of one fp32 element); its backward
    is the product's."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.zeros((), dtype=torch.float32, device=a.device).expand(
            *a.shape[:-1], b.shape[-1])

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = (g @ b.float().transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = (a.float().transpose(-1, -2) @ g).to(b.dtype)
        return ga, gb


class _Product(torch.autograd.Function):
    """The product of `MatmulF32` (``a`` and ``b`` held apart from the
    graph); the gradient passes to the stand-in unchanged."""

    @staticmethod
    def forward(ctx, stand_in, a, b):
        return _f32_product(a, b)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class MatmulF32:
    """a @ b (``[M,K] @ [K,N]``, or batched ``[B,M,K] @ [B,K,N]``) with an
    fp32 result.  On the card the forward is one bf16 GEMM writing fp32
    (``out_dtype``), an overload that has no derivative of its own; the
    backward is what JAX's transpose of ``dot_general(...,
    preferred_element_type=float32)`` computes: the fp32 cotangent times the
    other operand in fp32, rounded once to that operand's dtype.  On the CPU
    the forward upcasts both operands (the tests reach the backward so).

    The operands are saved (`_Operands`) before the product runs
    (`_Product`), as autograd saves a native op's: a checkpointed layer's
    recompute that needs only the operands of its last product stops
    before that product, as XLA drops the reference's dead recompute."""

    @staticmethod
    def apply(a, b):
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            return _Product.apply(_Operands.apply(a, b), a.detach(),
                                  b.detach())
        return _f32_product(a, b)


def _mm_plan(pa, pb, nd: int, batched: bool, split_k: bool = False):
    """One mesh axis of a DTensor ``a @ b`` (``a`` [..., M, K] of ``nd``
    dims @ ``b`` [K, N], or batched ``[B,M,K] @ [B,K,N]``): the placements
    the operands are brought to, the output's, and those of the operands'
    gradients.  Data-parallel (a on a leading dim), column-parallel (b on
    its columns), row-parallel (both on K: a partial output) and
    batch-parallel layouts run as they are; any other is gathered to one
    of them (an FSDP weight is all-gathered).

    A batched product of a replicated ``a`` and a ``b`` split on K (an
    expert weight's ``fsdp`` split over ``data``) is split as XLA splits
    the reference's: with ``split_k``, ``a`` is sliced on K and the
    product is row-parallel (a partial output); else ``b`` stays split
    here and `_GatherK` gathers it in the forward only (plan ``(rep,
    Shard(k_b), rep, rep, Shard(k_b))``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    rep = Replicate()
    if pa.is_partial():
        pa = rep
    if pb.is_partial():
        pb = rep
    if batched and (pa == Shard(0) or pb == Shard(0)):
        return Shard(0), Shard(0), Shard(0), Shard(0), Shard(0)
    k_a, k_b, n_b = nd - 1, (1 if batched else 0), (2 if batched else 1)
    if batched and pa == rep and pb == Shard(k_b):
        if not split_k:
            return rep, pb, rep, rep, pb                   # gathered K
        pa = Shard(k_a)                  # a slice of a, not a gathered b
    if pa == Shard(k_a) and pb in (Shard(k_b), rep):
        return pa, Shard(k_b), Partial(), pa, Shard(k_b)   # row-parallel
    if pa.is_shard() and pa.dim < k_a and not (batched and pa.dim == 0):
        return pa, rep, pa, pa, Partial()                  # data-parallel
    if pb == Shard(n_b):
        return rep, pb, Shard(nd - 1), Partial(), pb       # column-parallel
    return rep, rep, rep, rep, rep


def _split_k(a, b, i: int, rows=None) -> bool:
    """Whether the batched ``a @ b`` (``a`` replicated, ``b`` split on K
    over mesh dim ``i``) is split on K there: XLA's choice in the
    reference's partitioned module, the cheaper collective.  The fp32
    partial output [B, M, N] all-reduced against ``b`` all-gathered on K:
    the experts' g and u of a decode or a prefill's chunk (C 8) split on K
    over ``data``, a train step's or a whole prefill's (C 64 and more)
    gather the weight.  ``rows``: the M of the reference's product where
    ``a`` stacks several of them (a chunked prefill's chunks)."""
    al, bl = a.to_local(), b.to_local()
    partial = bl.shape[0] * (rows or al.shape[-2]) * bl.shape[-1] * 4
    gathered = bl.numel() * b.device_mesh.size(i) * bl.element_size()
    return partial < gathered


class _GatherK(torch.autograd.Function):
    """``local_mm(a, b)`` of local blocks where ``b`` [B, K/n, N] is split
    on K over some mesh dims (``pls``: its placements) and ``a`` [B, M, K]
    is whole: the forward gathers ``b``; the backward, as XLA's transpose
    of the reference's product, uses ``b``'s own slice: ``db = a[..., K
    slice]^T @ g`` (no gathered gradient to scatter back) and ``da`` the
    gathered ``g @ b^T`` slices."""

    @staticmethod
    def forward(ctx, a, b, mesh, pls, local_mm):
        from torch.distributed.tensor import DTensor, Replicate
        ctx.mesh, ctx.pls = mesh, pls
        ctx.save_for_backward(a, b)
        full = DTensor.from_local(b.detach(), mesh, pls, run_check=False
                                  ).redistribute(mesh, [Replicate()] *
                                                 mesh.ndim).to_local()
        return local_mm(a, full)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        a, b = ctx.saved_tensors
        mesh, pls = ctx.mesh, ctx.pls
        rep = [Replicate()] * mesh.ndim
        a_pls = [Shard(2) if pl.is_shard() else pl for pl in pls]
        ga = gb = None
        if ctx.needs_input_grad[0]:
            part = torch.bmm(g, b.to(g.dtype).transpose(1, 2))
            ga = DTensor.from_local(part, mesh, a_pls, run_check=False
                                    ).redistribute(mesh, rep).to_local()
            ga = ga.to(a.dtype)
        if ctx.needs_input_grad[1]:
            ak = DTensor.from_local(a, mesh, rep, run_check=False
                                    ).redistribute(mesh, a_pls).to_local()
            gb = torch.bmm(ak.to(g.dtype).transpose(1, 2), g).to(b.dtype)
        return ga, gb, None, None, None


def _dtensor_mm(a, b, local_mm, out_dtype=None, rows=None):
    """``a @ b`` on DTensors (``a`` [..., K] @ ``b`` [K, N], or batched
    ``[B,M,K] @ [B,K,N]``) as ``local_mm`` on the local shards: each
    operand brought to `_mm_plan`'s placements, the product of the local
    blocks (the leading dims folded into rows, as ``matmul`` folds them),
    and the result wrapped with the placements that layout gives it.  The
    leading dims are never merged on the DTensor: a merge of dims sharded
    over two mesh axes makes DTensor gather the whole tensor.

    ``out_dtype``: the result is cast to it.  Where it is narrower than
    fp32 and the layout sums over ranks (a row-parallel plan on a mesh
    axis of more than one rank), the local blocks' product is written in
    fp32 (`MatmulF32`), the partial sum reduced in fp32 and the sum rounded
    once, as XLA compiles the reference's ``preferred_element_type=float32``
    product: no partial leaves in a narrow dtype.  A batched product summed
    over ranks (the experts' g and u split on K) is reduced whatever its
    dtype: what reads it runs on the local blocks.  ``rows``: see
    `_split_k`."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = a.device_mesh
    if not isinstance(b, DTensor):
        b = DTensor.from_local(b, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    batched = b.dim() == 3
    plans = [_mm_plan(pa, pb, a.dim(), batched,
                      batched and mesh.size(i) > 1
                      and _split_k(a, b, i, rows))
             for i, (pa, pb) in enumerate(zip(a.placements, b.placements))]
    gather = [i for i, p in enumerate(plans) if batched and mesh.size(i) > 1
              and p[0].is_replicate() and p[1].is_shard(1)]
    summed = any(p[2].is_partial() and mesh.size(i) > 1
                 for i, p in enumerate(plans))
    rounds = summed and out_dtype not in (None, torch.float32)
    if rounds:
        local_mm = MatmulF32.apply
    reduce = rounds or (summed and batched)
    a2 = a.redistribute(mesh, [p[0] for p in plans])
    b2 = b.redistribute(mesh, [p[1] for p in plans])
    al = a2.to_local(grad_placements=[p[3] for p in plans])
    bl = b2.to_local(grad_placements=[p[4] for p in plans])
    if gather:
        out = _GatherK.apply(al, bl, mesh, [
            p[1] if i in gather else Replicate()
            for i, p in enumerate(plans)], local_mm)
    elif batched:
        out = local_mm(al, bl)
    else:
        out = local_mm(al.reshape(-1, al.shape[-1]), bl).reshape(
            *al.shape[:-1], bl.shape[-1])
    shape = (*a.shape[:-1], b.shape[-1])
    out = DTensor.from_local(out, mesh, [p[2] for p in plans],
                             run_check=False, shape=torch.Size(shape),
                             stride=_contiguous_strides(shape))
    if reduce:
        out = out.redistribute(mesh, [Replicate() if pl.is_partial() else pl
                                      for pl in out.placements])
    return out if out_dtype is None else out.to(out_dtype)


def _contiguous_strides(shape):
    strides, acc = [], 1
    for n in reversed(shape):
        strides.append(acc)
        acc *= n
    return tuple(reversed(strides))


def heads(t, n: int, hd: int):
    """``t`` [..., n * hd] viewed as [..., n, hd].  A DTensor split on its
    last dim over mesh axes whose product does not divide ``n`` (8 KV heads
    of 128 over 16 cards) is first gathered on that dim: DTensor cannot
    split a head across cards."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate
        last = t.dim() - 1
        mesh = t.device_mesh
        split = [i for i, p in enumerate(t.placements)
                 if p.is_shard() and p.dim == last]
        if n % int(np.prod([mesh.size(i) for i in split] or [1])):
            t = t.redistribute(mesh, [Replicate() if i in split else p
                                      for i, p in enumerate(t.placements)])
    return t.reshape(*t.shape[:-1], n, hd)


def _mm_f32(a, b):
    if is_dtensor(a):
        return _dtensor_mm(a, b, MatmulF32.apply)
    return MatmulF32.apply(a, b)


def matmul_f32(x, w):
    """x [..., d] @ w [d, f] with fp32 products and accumulation and an fp32
    result (the reference's ``preferred_element_type=float32`` without the
    cast back).  On the card a bf16 GEMM writes fp32 (``MatmulF32``) so that
    no weight is upcast in the forward; on DTensors the same GEMM runs on
    the local shards (`_dtensor_mm`)."""
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return _dtensor_mm(x, w, torch.mm) if is_dtensor(x) else x @ w
    if _on_card(x) and x.dtype == w.dtype:
        if is_dtensor(x):
            return _dtensor_mm(x, w, MatmulF32.apply)
        out = MatmulF32.apply(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    if is_dtensor(x):
        return _dtensor_mm(x.float(), w.float(), torch.mm)
    return x.float() @ w.float()


def bmatmul(a, b, rows=None):
    """Batched a @ b with fp32 accumulation, result in a.dtype (on DTensors,
    `_dtensor_mm`: a weight split on K alone is split as XLA splits the
    reference's product, on K (partials summed in fp32) or gathered in the
    forward only, by `_split_k` of ``rows``)."""
    if a.dtype == b.dtype and (a.dtype == torch.float32 or _on_card(a)):
        return _dtensor_mm(a, b, torch.bmm, a.dtype, rows) \
            if is_dtensor(a) else torch.bmm(a, b)
    if is_dtensor(a):
        return _dtensor_mm(a.float(), b.float(), torch.bmm, a.dtype, rows)
    return torch.bmm(a.float(), b.float()).to(a.dtype)


def bmatmul_f32(a, b):
    """Batched a @ b with an fp32 result (``MatmulF32`` on the card)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    if _on_card(a) and a.dtype == b.dtype:
        return _mm_f32(a, b)
    return torch.bmm(a.float(), b.float())


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rmsnorm(x, scale, eps=1e-5):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def layernorm(x, scale, bias, eps=1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)   # jnp.var: population
    return ((xf - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


class RMSNorm(Module):
    def __init__(self, d, device=None):
        super().__init__()
        self.param("scale", (d,), torch.float32, device, "ones")

    def forward(self, x, eps=1e-5):
        return rmsnorm(x, self.scale, eps)


class LayerNorm(Module):
    def __init__(self, d, device=None):
        super().__init__()
        self.param("scale", (d,), torch.float32, device, "ones")
        self.param("bias", (d,), torch.float32, device, "zeros")

    def forward(self, x, eps=1e-5):
        return layernorm(x, self.scale, self.bias, eps)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim, theta):
    exponent = np.arange(0, head_dim, 2, dtype=np.float32) / head_dim
    return 1.0 / (theta ** exponent)          # [head_dim//2]


def apply_rope(x, positions, theta):
    """x: [..., S, H, hd] (hd even); positions: broadcastable to [..., S]."""
    hd = x.shape[-1]
    freqs = torch.from_numpy(np.asarray(rope_freqs(hd, theta),
                                        np.float32)).to(x.device)
    angles = positions[..., :, None].float() * freqs       # [..., S, hd//2]
    angles = angles[..., None, :]                           # [..., S, 1, hd//2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq_len, d_model, device=None):
    """Whisper-style fixed sinusoidal embedding table [seq_len, d_model]."""
    pos = np.arange(seq_len, dtype=np.float32)[:, None]
    dim = np.arange(0, d_model, 2, dtype=np.float32)[None, :]
    inv = np.exp(-np.log(10000.0) * dim / d_model)
    tab = np.zeros((seq_len, d_model), np.float32)
    tab[:, 0::2] = np.sin(pos * inv)
    tab[:, 1::2] = np.cos(pos * inv)
    return torch.from_numpy(tab).to(device)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
class SwiGLU(Module):
    def __init__(self, d_model, d_ff, dtype, device=None):
        super().__init__()
        self.dense("wi", d_model, d_ff, dtype, device)     # gate
        self.dense("wu", d_model, d_ff, dtype, device)     # up
        self.dense("wo", d_ff, d_model, dtype, device)

    def forward(self, x):
        return swiglu(self, x)


def swiglu(p, x):
    g = matmul(x, p.wi)
    u = matmul(x, p.wu)
    return matmul(F.silu(g.float()).to(x.dtype) * u, p.wo)


class GeluMLP(Module):
    def __init__(self, d_model, d_ff, dtype, device=None):
        super().__init__()
        self.dense("wi", d_model, d_ff, dtype, device)
        self.param("bi", (d_ff,), dtype, device, "zeros")
        self.dense("wo", d_ff, d_model, dtype, device)
        self.param("bo", (d_model,), dtype, device, "zeros")

    def forward(self, x):
        return gelu_mlp(self, x)


def gelu_mlp(p, x):
    h = matmul(x, p.wi) + p.bi
    # jax.nn.gelu's default is the tanh form, not torch's erf default
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return matmul(h, p.wo) + p.bo


# ---------------------------------------------------------------------------
# embeddings / heads
# ---------------------------------------------------------------------------
class Table(Module):
    """A ``[vocab, d]`` table ``w``: the embedding (scale 0.02) or an untied
    head (scale 1/sqrt(d))."""

    def __init__(self, vocab, d_model, dtype, device=None, scale=0.02):
        super().__init__()
        self.param("w", (vocab, d_model), dtype, device, scale)


def embed(p, tokens):
    """Rows ``tokens`` of the table.  A DTensor table is gathered whole
    first (as FSDP gathers a weight), so that the lookup runs on the tokens
    where they lie; its gradient is reduce-scattered back to the table's
    shards.  (DTensor's own vocab-parallel lookup, a masked partial, fails
    to redistribute when the tokens move.)"""
    w = p.w
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(w, DTensor):
        w = w.redistribute(w.device_mesh,
                           [Replicate()] * w.device_mesh.ndim)
    return F.embedding(tokens, w)


def unembed(p, h):
    """h: [..., d] -> logits [..., vocab] in fp32."""
    return matmul_f32(h, p.w.t())
