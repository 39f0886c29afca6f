"""The LM substrate's configs and modules in the port (``repro_torch.configs``,
``repro_torch.models.{layers,attention,moe,ssm}``) against the JAX package,
on the CPU in float32.

Every case draws its inputs with numpy from a seed, builds the reference's
parameters with its own ``init`` and carries them across with
``convert.load_reference_tree``.  Tolerances: layers rtol 1e-5 / atol 1e-6
(the RoPE and sinusoid tables bitwise); attention rtol 2e-4 / atol 2e-4 (the
reference's own); MoE gates and aux 1e-6, outputs 1e-5, expert indices and
kept masks exact; SSM blocks 1e-4.
"""
import dataclasses
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import ssm as JS
from repro_torch import configs as tconfigs
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.convert import lm_params_from_reference, load_reference_tree
from repro_torch.models import attention as A
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models.analysis_flags import single_chunk, single_chunk_active

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-6)
ATT = dict(rtol=2e-4, atol=2e-4)
SSM = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def t(a):
    return torch.from_numpy(np.array(a))


def jit(fn):
    """The reference's ``fn(p, cfg, ...)`` jitted, the config static (its
    op-by-op dispatch is what makes it slow on the CPU)."""
    causal = ("causal",) if "causal" in inspect.signature(fn).parameters \
        else ()
    return jax.jit(fn, static_argnums=1, static_argnames=causal)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def cfgs(arch):
    """The reference's and the port's reduced configs of ``arch``."""
    return (jconfigs.get_config(arch).reduced(),
            tconfigs.get_config(arch).reduced())


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
def test_arch_ids_equal():
    assert set(tconfigs.ARCH_IDS) == set(jconfigs.ARCH_IDS)
    assert tconfigs.all_arch_ids() == jconfigs.all_arch_ids()
    assert len(tconfigs.ARCH_IDS) == 10


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCH_IDS))
def test_config_fields_equal(arch):
    """Every field, the sharding and analysis ones included, and the
    reduced config, field for field."""
    j, p = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert dataclasses.asdict(p.reduced()) == dataclasses.asdict(j.reduced())
    assert p.resolved_head_dim == j.resolved_head_dim
    assert (p.is_enc_dec, p.is_attention_free, p.is_subquadratic) == \
        (j.is_enc_dec, j.is_attention_free, j.is_subquadratic)
    assert tconfigs.applicable_shapes(p) == jconfigs.applicable_shapes(j)
    r = p.replace(remat="nothing", prefill_chunks=2)
    assert dataclasses.asdict(r) == dataclasses.asdict(
        j.replace(remat="nothing", prefill_chunks=2))


def test_shapes_and_registry():
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert tconfigs.SHAPES["decode_32k"].is_decode
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_rmsnorm_and_layernorm():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 48).astype(np.float32) * 3 + 1
    scale = rng.randn(48).astype(np.float32)
    bias = rng.randn(48).astype(np.float32)
    close(L.rmsnorm(t(x), t(scale), 1e-5),
          JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-5), **F32)
    close(L.layernorm(t(x), t(scale), t(bias), 1e-6),
          JL.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                       jnp.asarray(x), 1e-6), **F32)


@pytest.mark.parametrize("hd,theta", [(16, 1e4), (64, 1e6), (128, 5e5),
                                      (8, 1e4)])
def test_rope_tables_bitwise_and_rotation(hd, theta):
    assert np.array_equal(L.rope_freqs(hd, theta), JL.rope_freqs(hd, theta))
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 3, hd).astype(np.float32)
    pos = np.array([[0, 1, 7, 100, 4095, 32767]], np.int32)
    close(L.apply_rope(t(x), t(pos).long(), theta),
          JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta), **F32)


def test_sinusoidal_positions_bitwise():
    for s, d in ((16, 64), (1500, 1280)):
        assert np.array_equal(L.sinusoidal_positions(s, d).numpy(),
                              np.asarray(JL.sinusoidal_positions(s, d)))


def test_swiglu_and_gelu_mlp():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 7, 32).astype(np.float32)
    jp = JL.swiglu_init(jax.random.PRNGKey(0), 32, 80, jnp.float32)
    port = load_reference_tree(L.SwiGLU(32, 80, torch.float32), jp)
    close(port(t(x)), JL.swiglu(jp, jnp.asarray(x)), **F32)
    jp = JL.gelu_mlp_init(jax.random.PRNGKey(1), 32, 80, jnp.float32)
    jp = dict(jp, bi=jnp.asarray(rng.randn(80).astype(np.float32)),
              bo=jnp.asarray(rng.randn(32).astype(np.float32)))
    port = load_reference_tree(L.GeluMLP(32, 80, torch.float32), jp)
    # the tanh form: torch's erf default would miss this tolerance
    close(port(t(x) * 3), JL.gelu_mlp(jp, jnp.asarray(x) * 3), **F32)


def test_embed_and_unembed():
    rng = np.random.RandomState(3)
    w = rng.randn(50, 24).astype(np.float32)
    tok = rng.randint(0, 50, (3, 9)).astype(np.int32)
    h = rng.randn(3, 9, 24).astype(np.float32)
    table = load_reference_tree(L.Table(50, 24, torch.float32),
                                {"w": jnp.asarray(w)})
    close(L.embed(table, t(tok).long()),
          JL.embed({"w": jnp.asarray(w)}, jnp.asarray(tok)), rtol=0, atol=0)
    logits = L.unembed(table, t(h))
    assert logits.dtype == torch.float32
    close(logits, JL.unembed({"w": jnp.asarray(w)}, jnp.asarray(h)), **F32)
    # bf16 weights still give fp32 logits
    tb = L.Table(50, 24, torch.bfloat16)
    tb.w.data.copy_(t(w))
    assert L.unembed(tb, t(h).bfloat16()).dtype == torch.float32


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sq,sk,causal,chunk", [
    (16, 16, True, 8), (16, 16, False, 8), (8, 32, False, 8),
    (64, 64, True, 8), (8, 24, True, 16)])      # the last: gcd fallback
def test_online_and_einsum_match_reference(sq, sk, causal, chunk):
    rng = np.random.RandomState(0)
    q = rng.randn(2, sq, 4, 16).astype(np.float32)
    k = rng.randn(2, sk, 4, 16).astype(np.float32)
    v = rng.randn(2, sk, 4, 16).astype(np.float32)
    want = JA.attention_einsum(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal)
    want_on = JA.attention_online(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal, chunk=chunk)
    ein = A.attention_einsum(t(q), t(k), t(v), causal=causal)
    onl = A.attention_online(t(q), t(k), t(v), causal=causal, chunk=chunk)
    close(ein, want, **ATT)
    close(onl, want_on, **ATT)
    close(onl, ein.numpy(), **ATT)


def test_online_mixed_head_dims():
    rng = np.random.RandomState(1)
    q = rng.randn(1, 8, 2, 24).astype(np.float32)
    k = rng.randn(1, 8, 2, 24).astype(np.float32)
    v = rng.randn(1, 8, 2, 16).astype(np.float32)
    want = JA.attention_online(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=True, chunk=4)
    got = A.attention_online(t(q), t(k), t(v), causal=True, chunk=4)
    assert tuple(got.shape) == (1, 8, 2, 16)
    close(got, want, **ATT)
    close(got, A.attention_einsum(t(q), t(k), t(v), causal=True).numpy(),
          **ATT)


def test_online_switch_threshold():
    assert A.ONLINE_ATTN_MIN_SEQ == JA.ONLINE_ATTN_MIN_SEQ == 4096
    assert A.NEG_INF == JA.NEG_INF == -1e30


def test_expand_kv_maps_head_to_kv_head_floor():
    k = torch.arange(2 * 3 * 2 * 4, dtype=torch.float32).view(2, 3, 2, 4)
    got = A._expand_kv(k, 3)
    want = JA._expand_kv(jnp.asarray(k.numpy()), 3)
    close(got, want, rtol=0, atol=0)
    assert torch.equal(got[:, :, 2], k[:, :, 0])    # head 2 -> kv head 0


def test_decode_attention():
    rng = np.random.RandomState(2)
    q = rng.randn(2, 1, 4, 16).astype(np.float32)
    kc = rng.randn(2, 10, 2, 16).astype(np.float32)
    vc = rng.randn(2, 10, 2, 16).astype(np.float32)
    for pos in (0, 6, 9):
        close(A.decode_attention(t(q), t(kc), t(vc), pos),
              JA.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), pos), **ATT)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen1.5-110b"])
def test_gqa_full_prefill_and_decode(arch):
    """Full, prefill and step decode against the reference, and the port's
    step decode against its own full attention (qwen: QKV bias)."""
    jcfg, pcfg = cfgs(arch)
    jp = JA.gqa_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    rng = np.random.RandomState(2)
    jp = {k: (jnp.asarray(rng.randn(*v.shape).astype(np.float32))
              if k.startswith("b") else v) for k, v in jp.items()}
    port = load_reference_tree(A.GQA(pcfg, torch.float32), jp)
    s = 6
    x = rng.randn(2, s, jcfg.d_model).astype(np.float32)
    positions = np.arange(s)[None, :]
    full = port(t(x), t(positions), causal=True)
    close(full, jit(JA.gqa_attention)(jp, jcfg, jnp.asarray(x),
                                 jnp.asarray(positions), causal=True), **ATT)
    out, k, v = port.prefill(t(x), t(positions))
    jout, jk, jv = jit(JA.gqa_prefill)(jp, jcfg, jnp.asarray(x),
                                  jnp.asarray(positions))
    for got, want in ((out, jout), (k, jk), (v, jv)):
        close(got, want, **ATT)
    hd = jcfg.resolved_head_dim
    kc = torch.zeros((2, s, jcfg.n_kv_heads, hd))
    vc = torch.zeros_like(kc)
    jkc, jvc = jnp.asarray(kc.numpy()), jnp.asarray(vc.numpy())
    steps = []
    for i in range(s):
        o, kc2, vc2 = port.decode(t(x[:, i:i + 1]), kc, vc, i)
        assert kc2 is kc and vc2 is vc             # written in place
        jo, jkc, jvc = jit(JA.gqa_decode)(jp, jcfg, jnp.asarray(x[:, i:i + 1]),
                                     jkc, jvc, i)
        close(o, jo, **ATT)
        steps.append(o)
    close(kc, jkc, **ATT)
    close(torch.cat(steps, 1), full.numpy(), rtol=1e-3, atol=1e-3)


def test_cross_attention_plain_and_cached():
    jcfg, pcfg = cfgs("whisper-large-v3")
    jp = JA.cross_attn_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    port = load_reference_tree(A.CrossAttention(pcfg, torch.float32), jp)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, jcfg.d_model).astype(np.float32)
    enc = rng.randn(2, 16, jcfg.d_model).astype(np.float32)
    close(port(t(x), t(enc)),
          JA.cross_attention(jp, jcfg, jnp.asarray(x), jnp.asarray(enc)),
          **ATT)
    k, v = port.kv(t(enc))
    close(port.cached(t(x[:, :1]), k, v),
          JA.cross_attention_cached(jp, jcfg, jnp.asarray(x[:, :1]),
                                    jnp.asarray(k.numpy()),
                                    jnp.asarray(v.numpy())), **ATT)


def test_mla_naive_and_absorbed_decode():
    jcfg, pcfg = cfgs("deepseek-v3-671b")
    jp = JA.mla_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    port = load_reference_tree(A.MLA(pcfg, torch.float32), jp)
    rng = np.random.RandomState(3)
    s = 5
    x = rng.randn(2, s, jcfg.d_model).astype(np.float32)
    positions = np.arange(s)[None, :]
    full, ckv, kr = port(t(x), t(positions), causal=True)
    jfull, jckv, jkr = jit(JA.mla_attention)(jp, jcfg, jnp.asarray(x),
                                        jnp.asarray(positions), causal=True)
    for got, want in ((full, jfull), (ckv, jckv), (kr, jkr)):
        close(got, want, **ATT)
    m = jcfg.mla
    cc = torch.zeros((2, s, m.kv_lora_rank))
    kc = torch.zeros((2, s, m.qk_rope_head_dim))
    jcc, jkc = jnp.asarray(cc.numpy()), jnp.asarray(kc.numpy())
    steps = []
    for i in range(s):
        o, _, _ = port.decode(t(x[:, i:i + 1]), cc, kc, i)
        jo, jcc, jkc = jit(JA.mla_decode_absorbed)(jp, jcfg,
                                              jnp.asarray(x[:, i:i + 1]),
                                              jcc, jkc, i)
        close(o, jo, **ATT)
        steps.append(o)
    close(cc, jcc, **ATT)
    close(kc, jkc, **ATT)
    close(torch.cat(steps, 1), full.numpy(), rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def make_moe(e=4, k=2, cf=8.0, shared=0):
    kw = dict(arch_id="test-moe", family="moe", n_layers=1, d_model=32,
              n_heads=4, n_kv_heads=4, d_ff=64, vocab_size=64)
    mk = dict(n_experts=e, n_experts_per_tok=k, d_ff_expert=48,
              capacity_factor=cf, n_shared_experts=shared)
    return (JModelConfig(moe=JMoEConfig(**mk), **kw),
            ModelConfig(moe=MoEConfig(**mk), **kw))


def moe_pair(seed, **kw):
    jcfg, pcfg = make_moe(**kw)
    jp = JM.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jcfg, pcfg, jp, load_reference_tree(M.MoE(pcfg, torch.float32), jp)


def reference_keep(idx, n_experts, c):
    """moe.py's dispatch plan, in jnp, from the reference's expert ids."""
    flat = idx.reshape(-1)
    order = jnp.argsort(flat)
    counts = jnp.bincount(flat, length=n_experts)
    seg = jnp.concatenate([jnp.zeros((1,), counts.dtype),
                           jnp.cumsum(counts)[:-1]])
    pos = jnp.arange(flat.shape[0]) - seg[flat[order]]
    return np.asarray(order), np.asarray(pos < c)


def dense_oracle(p, cfg, x):
    """Every token through every expert, weighted by its gates (torch)."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    gates, idx, _ = M.route(p, cfg, xt)
    h = torch.nn.functional.silu(torch.einsum("td,edf->etf", xt, p.wi)) * \
        torch.einsum("td,edf->etf", xt, p.wu)
    ye = torch.einsum("etf,efd->etd", h, p.wo)
    w = torch.zeros((xt.shape[0], cfg.moe.n_experts))
    w.scatter_(1, idx, gates)
    return torch.einsum("te,etd->td", w, ye).reshape(b, s, d)


def test_route_matches_reference():
    jcfg, pcfg, jp, port = moe_pair(1)
    x = np.random.RandomState(1).randn(16, 32).astype(np.float32)
    gates, idx, aux = M.route(port, pcfg, t(x))
    jg, ji, ja = JM.route(jp, jcfg, jnp.asarray(x))
    close(gates, jg, rtol=0, atol=1e-6)
    assert np.array_equal(idx.numpy(), np.asarray(ji))
    # the router's fp32 logits differ in the last ulp between XLA's and
    # torch's matmul, so aux is held as the gates are
    np.testing.assert_allclose(float(aux), float(ja), rtol=1e-6)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert all(len(set(row)) == len(row) for row in idx.numpy())


def test_route_ties_go_to_the_lower_expert():
    """All scores equal: lax.top_k keeps experts 0..k-1, so must the port."""
    jcfg, pcfg, jp, port = moe_pair(1, e=8, k=3)
    port.router.data.zero_()
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    x = np.random.RandomState(2).randn(5, 32).astype(np.float32)
    _, idx, _ = M.route(port, pcfg, t(x))
    _, ji, _ = JM.route(jp, jcfg, jnp.asarray(x))
    assert np.array_equal(idx.numpy(), np.asarray(ji))
    assert np.array_equal(idx.numpy(), np.tile([0, 1, 2], (5, 1)))


@pytest.mark.parametrize("cf,shape", [(8.0, (2, 8)), (0.5, (2, 32)),
                                      (1.25, (3, 16))])
def test_moe_apply_matches_reference(cf, shape):
    """No drops (cf 8), capacity drops (cf 0.5: kept masks equal) and the
    configs' own factor."""
    jcfg, pcfg, jp, port = moe_pair(0, cf=cf)
    x = np.random.RandomState(0).randn(*shape, 32).astype(np.float32)
    y, aux = M.moe_apply(port, pcfg, t(x))
    jy, jaux = jit(JM.moe_apply)(jp, jcfg, jnp.asarray(x))
    close(y, jy, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    t_tokens = shape[0] * shape[1]
    c = M.capacity(pcfg, t_tokens)
    _, idx, _ = M.route(port, pcfg, t(x).reshape(t_tokens, 32))
    _, ji, _ = JM.route(jp, jcfg, jnp.asarray(x).reshape(t_tokens, 32))
    order, _, _, _, keep = M.dispatch(idx, 4, c)
    jorder, jkeep = reference_keep(ji, 4, c)
    assert np.array_equal(order.numpy(), jorder)
    assert np.array_equal(keep.numpy(), jkeep)
    if cf < 1:
        assert not keep.all()


def test_moe_matches_dense_oracle_when_no_drops():
    _, pcfg, _, port = moe_pair(0, cf=8.0)
    x = t(np.random.RandomState(0).randn(2, 8, 32).astype(np.float32))
    y, aux = M.moe_apply(port, pcfg, x)
    close(y, dense_oracle(port, pcfg, x).detach().numpy(), rtol=1e-4,
          atol=1e-4)
    assert float(aux) > 0.0


def test_capacity_drops_are_bounded():
    _, pcfg, _, port = moe_pair(2, cf=0.25)
    x = t(np.random.RandomState(2).randn(2, 32, 32).astype(np.float32))
    y, _ = M.moe_apply(port, pcfg, x)
    assert torch.isfinite(y).all()
    y_full, _ = M.moe_apply(port, make_moe(cf=8.0)[1], x)
    assert float(torch.linalg.norm(y)) <= float(torch.linalg.norm(y_full)) \
        + 1e-3


def test_shared_experts_added():
    jcfg, pcfg, jp, port = moe_pair(3, shared=1)
    assert "shared" in jp and hasattr(port, "shared")
    x = np.random.RandomState(3).randn(1, 4, 32).astype(np.float32)
    y, _ = M.moe_apply(port, pcfg, t(x))
    close(y, jit(JM.moe_apply)(jp, jcfg, jnp.asarray(x))[0], rtol=1e-5, atol=1e-5)


def test_capacity_formula():
    for e, k, cf in ((8, 2, 1.0), (4, 2, 8.0), (256, 8, 1.25), (16, 4, 1.25)):
        jcfg, pcfg = make_moe(e=e, k=k, cf=cf)
        for n in (1, 4, 64, 1024, 2048):
            assert M.capacity(pcfg, n) == JM.capacity(jcfg, n)
    c = M.capacity(make_moe(e=8, k=2, cf=1.0)[1], 1024)
    assert c >= 1024 * 2 // 8 and c % 8 == 0


def test_moe_combine_is_deterministic_in_bf16():
    _, pcfg, _, port = moe_pair(4, e=8, k=4)
    port = port.to(torch.bfloat16)
    port.router.data = port.router.data.float()
    x = t(np.random.RandomState(4).randn(2, 64, 32).astype(np.float32)
          ).bfloat16()
    y1, _ = M.moe_apply(port, pcfg, x)
    y2, _ = M.moe_apply(port, pcfg, x)
    assert torch.equal(y1, y2)


# ---------------------------------------------------------------------------
# SSM
# ---------------------------------------------------------------------------
def run_decode(block, x, state):
    outs = []
    for i in range(x.shape[1]):
        o, state2 = block.decode(x[:, i:i + 1], state)
        assert state2 is state                     # updated in place
        outs.append(o)
    return torch.cat(outs, 1)


def run_jax_decode(fn, p, cfg, x, state):
    outs = []
    fn = jit(fn)
    for i in range(x.shape[1]):
        o, state = fn(p, cfg, jnp.asarray(x[:, i:i + 1]), state)
        outs.append(o)
    return jnp.concatenate(outs, 1), state


@pytest.mark.parametrize("seq,chunk", [(16, 4), (12, 12), (24, 8)])
def test_mamba2_against_reference(seq, chunk):
    jcfg, pcfg = cfgs("zamba2-2.7b")
    jcfg = jcfg.replace(ssm=jcfg.ssm.__class__(
        d_state=8, d_conv=4, expand=2, head_dim=8, chunk_size=chunk))
    pcfg = pcfg.replace(ssm=pcfg.ssm.__class__(
        d_state=8, d_conv=4, expand=2, head_dim=8, chunk_size=chunk))
    jp = JS.mamba2_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    port = load_reference_tree(S.Mamba2(pcfg, torch.float32), jp)
    x = (np.random.RandomState(0).randn(2, seq, jcfg.d_model) * 0.3
         ).astype(np.float32)
    y = port(t(x))
    close(y, jit(JS.mamba2_apply)(jp, jcfg, jnp.asarray(x)), **SSM)
    st = S.mamba2_init_state(pcfg, 2)
    y_seq = run_decode(port, t(x), st)
    jy, jst = run_jax_decode(JS.mamba2_decode, jp, jcfg, x,
                             JS.mamba2_init_state(jcfg, 2))
    close(y_seq, jy, **SSM)
    close(st["ssm"], jst["ssm"], **SSM)
    close(st["conv"], jst["conv"], **SSM)
    close(y_seq, y.numpy(), rtol=2e-3, atol=2e-3)


def test_mamba2_state_decay_bounds():
    _, pcfg = cfgs("zamba2-2.7b")
    port = S.Mamba2(pcfg, torch.float32).init(torch.Generator().manual_seed(3))
    st = S.mamba2_init_state(pcfg, 1)
    x = torch.ones((1, 1, pcfg.d_model))
    for _ in range(50):
        port.decode(x, st)
    assert torch.isfinite(st["ssm"]).all()
    assert float(st["ssm"].abs().max()) < 1e4


@pytest.mark.parametrize("seq", [8, 16])
def test_mlstm_against_reference(seq):
    jcfg, pcfg = cfgs("xlstm-350m")
    jp = JS.mlstm_init(jax.random.PRNGKey(1), jcfg, jnp.float32)
    port = load_reference_tree(S.MLSTM(pcfg, torch.float32), jp)
    x = (np.random.RandomState(1).randn(2, seq, jcfg.d_model) * 0.3
         ).astype(np.float32)
    y = port(t(x))
    close(y, jit(JS.mlstm_apply)(jp, jcfg, jnp.asarray(x)), **SSM)
    # the reference's test upcasts the bf16 conv window of the first state;
    # each step stores it back in bf16, as the reference's does
    st = S.mlstm_init_state(pcfg, 2)
    st["conv"] = st["conv"].float()
    jst = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        JS.mlstm_init_state(jcfg, 2))
    y_seq = run_decode(port, t(x), st)
    jy, jst = run_jax_decode(JS.mlstm_decode, jp, jcfg, x, jst)
    close(y_seq, jy, **SSM)
    for k in ("C", "n", "m"):
        close(st[k], jst[k], **SSM)
    close(y_seq, y.numpy(), rtol=5e-3, atol=5e-3)


def test_slstm_against_reference():
    jcfg, pcfg = cfgs("xlstm-350m")
    jp = JS.slstm_init(jax.random.PRNGKey(2), jcfg, jnp.float32)
    port = load_reference_tree(S.SLSTM(pcfg, torch.float32), jp)
    x = (np.random.RandomState(2).randn(2, 10, jcfg.d_model) * 0.3
         ).astype(np.float32)
    y = port(t(x))
    close(y, jit(JS.slstm_apply)(jp, jcfg, jnp.asarray(x)), **SSM)
    st = S.slstm_init_state(pcfg, 2)
    y_seq = run_decode(port, t(x), st)
    jy, jst = run_jax_decode(JS.slstm_decode, jp, jcfg, x,
                             JS.slstm_init_state(jcfg, 2))
    close(y_seq, jy, **SSM)
    for k in ("c", "n", "h", "m"):
        close(st[k], jst[k], **SSM)
    close(y_seq, y.numpy(), rtol=2e-3, atol=2e-3)


def test_softplus_has_no_threshold():
    """jax.nn.softplus is logaddexp(x, 0): torch's F.softplus turns into the
    identity above 20, which differs in float32 at 20 < x < ~30."""
    x = np.array([-30.0, -1.0, 0.0, 5.0, 20.5, 25.0, 100.0], np.float32)
    close(S.softplus(t(x)), jax.nn.softplus(jnp.asarray(x)), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the converter, the device rule, the analysis flag
# ---------------------------------------------------------------------------
def test_converter_rejects_missing_unknown_and_misshaped_leaves():
    jcfg, pcfg = cfgs("smollm-135m")
    from repro.models import build_model as jbuild
    params = jax.tree_util.tree_map(
        np.asarray, jbuild(jcfg.replace(dtype="float32")).init(
            jax.random.PRNGKey(0)))
    pcfg = pcfg.replace(dtype="float32")
    lm_params_from_reference(pcfg, params, device="cpu")
    bad = dict(params, extra={"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="extra"):
        lm_params_from_reference(pcfg, bad, device="cpu")
    bad = {k: v for k, v in params.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="final_norm"):
        lm_params_from_reference(pcfg, bad, device="cpu")
    bad = dict(params, emb={"w": params["emb"]["w"][:, :-1]})
    with pytest.raises(ValueError, match="emb"):
        lm_params_from_reference(pcfg, bad, device="cpu")
    # a stack with one layer more than the port's model
    stack = jax.tree_util.tree_map(lambda a: np.concatenate([a, a[:1]]),
                                   params["stack"])
    with pytest.raises(ValueError, match="not all of them"):
        lm_params_from_reference(pcfg, dict(params, stack=stack),
                                 device="cpu")
    # bf16 parameters into a float32 model
    with pytest.raises(ValueError, match="bfloat16"):
        lm_params_from_reference(pcfg, jax.tree_util.tree_map(
            lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), params),
            device="cpu")


def test_build_model_needs_cuda_or_an_explicit_cpu():
    cfg = tconfigs.get_config("smollm-135m").reduced()
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA, so the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    model = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    assert model.emb.w.device.type == "cpu"
    assert model.emb.w.dtype == torch.bfloat16
    assert model.final_norm.scale.dtype == torch.float32
    with torch.inference_mode():
        logits, _ = model({"tokens": torch.zeros((1, 4), dtype=torch.long)})
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()


def test_init_is_seeded_and_fills_every_parameter():
    cfg = tconfigs.get_config("zamba2-2.7b").reduced()
    a = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    b = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(5))
    for (name, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), name
        assert torch.isfinite(pa).all(), name
    assert torch.equal(a.stack[0].mamba[0].m.dt_bias.data, torch.from_numpy(
        np.log(np.expm1(np.linspace(1e-3, 1e-1, a.stack[0].mamba[0].m.dt_bias
                                    .numel(), dtype=np.float32)))))


def test_single_chunk_flag_scoped():
    assert not single_chunk_active()
    with single_chunk():
        assert single_chunk_active()
    assert not single_chunk_active()
