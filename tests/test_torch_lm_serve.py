"""The LM substrate's serving path in the port (``BaseLM.prefill`` and its
request chunks, ``repro_torch.serve.lm``) against the JAX package, on the
CPU at reduced configs, with the reference's parameters carried across by
``convert.lm_params_from_reference``.

Float32 throughout unless a case says otherwise: logits and caches within
rtol 1e-4 / atol 1e-4.  Greedy tokens must equal the reference's at every
step where the reference's top-two logit gap exceeds ``TIE_GAP``; a step
under it is a near tie, reported rather than avoided.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.serve.lm import greedy_generate as jgreedy
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.serve.lm import greedy_generate, make_decode_fn, \
    make_prefill_fn

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

F32 = dict(rtol=1e-4, atol=1e-4)
TIE_GAP = 1e-3


def pair(arch, dtype="float32", seed=0, capacity_factor=None):
    """(reference cfg, model, params) and the port's model on those params,
    at ``arch``'s reduced config (a MoE's capacity factor replaced if
    given)."""
    def reduced(get):
        cfg = get(arch).reduced().replace(remat="nothing", dtype=dtype)
        if capacity_factor is not None:
            cfg = cfg.replace(moe=dataclasses.replace(
                cfg.moe, capacity_factor=capacity_factor))
        return cfg

    jcfg, pcfg = reduced(jget_config), reduced(get_config)
    jmodel = jbuild_model(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed))
    port = lm_params_from_reference(
        pcfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return jcfg, jmodel, params, port


def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def arr(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def close_trees(got, want, **tol):
    """Two caches (dicts of tensors or arrays) leaf by leaf, keys sorted."""
    g, w = leaves(got), leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(arr(a), arr(b), **tol)


def tokens(cfg, shape, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "dbrx-132b",
                                  "deepseek-v3-671b"])
def test_chunked_prefill_matches_unchunked_and_reference(arch):
    """Two request chunks equal one (the MoE archs at ample capacity, as
    the reference's test: drops depend on the batch), and both equal the
    reference's prefill, logits and cache."""
    ample = 16.0 if get_config(arch).moe is not None else None
    jcfg, jmodel, params, port = pair(arch, capacity_factor=ample)
    tok = tokens(jcfg, (4, 16), 0)
    want_logits, want_cache = jax.jit(jmodel.prefill)(
        params, {"tokens": jnp.asarray(tok)})
    logits1, cache1 = port.prefill({"tokens": torch.from_numpy(tok).long()})
    port.cfg = port.cfg.replace(prefill_chunks=2)
    logits2, cache2 = port.prefill({"tokens": torch.from_numpy(tok).long()})
    np.testing.assert_allclose(logits1.numpy(), logits2.numpy(), **F32)
    close_trees(cache1, cache2, **F32)
    np.testing.assert_allclose(logits1.numpy(), np.asarray(want_logits),
                               **F32)
    close_trees(cache1, want_cache, **F32)


def test_prefill_last_logits_match_forward():
    jcfg, jmodel, params, port = pair("internlm2-1.8b", seed=1)
    tok = torch.from_numpy(tokens(jcfg, (2, 12), 1)).long()
    with torch.inference_mode():
        logits_fwd, _ = port({"tokens": tok})
    logits_pre, cache = port.prefill({"tokens": tok})
    np.testing.assert_allclose(logits_pre[:, 0].numpy(),
                               logits_fwd[:, -1].numpy(), rtol=1e-5,
                               atol=1e-5)
    assert cache["k"].shape[2] == 12     # [L, B, S, ...]


def test_vlm_prefix_against_reference():
    """InternVL: forward and prefill with the image prefix, against the
    reference's; decode then continues from the prefix's K/V."""
    jcfg, jmodel, params, port = pair("internvl2-2b")
    rng = np.random.RandomState(1)
    s = 6
    tok = tokens(jcfg, (2, s), 1)
    patches = rng.randn(2, jcfg.n_image_patches, jcfg.d_model).astype(
        np.float32)
    jbatch = {"tokens": jnp.asarray(tok), "patches": jnp.asarray(patches)}
    batch = {"tokens": torch.from_numpy(tok).long(),
             "patches": torch.from_numpy(patches)}
    want, _ = jax.jit(jmodel.forward)(params, jbatch)
    with torch.inference_mode():
        got, _ = port(batch)
    assert got.shape[1] == s + jcfg.n_image_patches
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    want_l, want_c = jax.jit(jmodel.prefill)(params, jbatch)
    got_l, got_c = port.prefill(batch)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **F32)
    close_trees(got_c, want_c, **F32)
    # decode at the next position against a cache holding the prefix
    n = s + jcfg.n_image_patches
    cache = port.init_cache(2, n + 1)
    jcache = jmodel.init_cache(2, n + 1)
    for name in ("k", "v"):
        cache[name][:, :, :n] = got_c[name]
        jcache[name] = jcache[name].at[:, :, :n].set(want_c[name])
    nxt = tok[:, -1:]
    lg, _ = port.decode_step(cache, torch.from_numpy(nxt).long(), n)
    jlg, _ = jax.jit(jmodel.decode_step)(params, jcache, jnp.asarray(nxt),
                                         jnp.int32(n))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **F32)


@pytest.mark.parametrize("arch", ["smollm-135m", "internvl2-2b"])
def test_greedy_generate_against_reference(arch):
    """Every step's logits within 1e-4 of the reference's (the reference's
    own tokens fed to both), and the tokens equal wherever the reference's
    top-two gap exceeds TIE_GAP; the port's greedy_generate gives the same
    tokens, and so does the reference's."""
    jcfg, jmodel, params, port = pair(arch)
    b, s0, n = 2, 4, 6
    prompt = tokens(jcfg, (b, s0), 0)
    decode = jax.jit(jmodel.decode_step)
    jcache = jmodel.init_cache(b, s0 + n)
    cache = port.init_cache(b, s0 + n)
    fed = prompt
    chosen, near_ties = [], []
    for i in range(s0 + n):
        tok = fed[:, i:i + 1]
        jl, jcache = decode(params, jcache, jnp.asarray(tok), jnp.int32(i))
        pl, cache = port.decode_step(cache, torch.from_numpy(tok).long(), i)
        jl = np.asarray(jl)[:, -1]
        np.testing.assert_allclose(pl[:, -1].numpy(), jl, **F32,
                                   err_msg=f"step {i}")
        want = jl.argmax(-1)
        top2 = np.sort(jl, -1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > TIE_GAP
        got = pl[:, -1].numpy().argmax(-1)
        assert np.array_equal(got[sure], want[sure]), f"step {i}"
        near_ties += [(i, int(r)) for r in np.flatnonzero(~sure)]
        if i >= s0 - 1:
            chosen.append(want)
            if i < s0 + n - 1:
                fed = np.concatenate([fed, want[:, None].astype(np.int32)], 1)
    print(f"{arch}: near ties (step, row): {near_ties}")
    want_tokens = np.stack(chosen[:n], 1)
    out = greedy_generate(port, torch.from_numpy(prompt).long(), n)
    assert tuple(out.shape) == (b, n)
    if not near_ties:
        assert np.array_equal(out.numpy(), want_tokens)
        assert np.array_equal(np.asarray(jgreedy(jmodel, params,
                                                 jnp.asarray(prompt), n)),
                              want_tokens)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_greedy_generate_deterministic(dtype):
    cfg = get_config("deepseek-v3-671b").reduced().replace(dtype=dtype)
    from repro_torch.models import build_model
    model = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    prompt = torch.from_numpy(tokens(cfg, (2, 4), 0)).long()
    out1 = greedy_generate(model, prompt, n_steps=6)
    out2 = greedy_generate(model, prompt, n_steps=6)
    assert torch.equal(out1, out2)
    assert tuple(out1.shape) == (2, 6)


def test_prefill_and_decode_fns():
    jcfg, jmodel, params, port = pair("glm4-9b")
    tok = torch.from_numpy(tokens(jcfg, (2, 5), 2)).long()
    logits, cache = make_prefill_fn(port)({"tokens": tok})
    want, _ = port.prefill({"tokens": tok})
    assert torch.equal(logits, want)
    decode = make_decode_fn(port)
    c = port.init_cache(2, 5)
    for i in range(5):
        lg, c = decode(c, tok[:, i:i + 1], i)
    np.testing.assert_allclose(lg[:, 0].numpy(), logits[:, 0].numpy(), **F32)
    close_trees(c, cache, **F32)


@pytest.mark.parametrize("arch", ["whisper-large-v3", "xlstm-350m",
                                  "zamba2-2.7b"])
def test_prefill_contracts_mirror_the_reference(arch):
    """Whisper's prefill returns only the cross K/V, xLSTM's a fresh empty
    state and Zamba's None, as the reference's do; the last logits equal
    the reference's."""
    jcfg, jmodel, params, port = pair(arch)
    tok = tokens(jcfg, (2, 8), 3)
    jbatch, batch = {"tokens": jnp.asarray(tok)}, \
        {"tokens": torch.from_numpy(tok).long()}
    if jcfg.is_enc_dec:
        frames = np.random.RandomState(3).randn(
            2, jcfg.encoder_seq_len, jcfg.d_model).astype(np.float32)
        jbatch["frames"] = jnp.asarray(frames)
        batch["frames"] = torch.from_numpy(frames)
    want_l, want_c = jax.jit(jmodel.prefill)(params, jbatch)
    got_l, got_c = port.prefill(batch)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **F32)
    if want_c is None:
        assert got_c is None
        return
    assert sorted(got_c) == sorted(want_c)
    close_trees(got_c, want_c, **F32)


@pytest.mark.parametrize("arch", ["smollm-135m", "internvl2-2b",
                                  "whisper-large-v3", "dbrx-132b"])
def test_loss_forward_only_against_reference(arch):
    jcfg, jmodel, params, port = pair(arch)
    rng = np.random.RandomState(4)
    tok, labels = tokens(jcfg, (2, 8), 4), tokens(jcfg, (2, 8), 5)
    labels[0, :3] = -1                          # ignored positions
    jbatch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(labels)}
    batch = {"tokens": torch.from_numpy(tok).long(),
             "labels": torch.from_numpy(labels).long()}
    if jcfg.n_image_patches:
        p = rng.randn(2, jcfg.n_image_patches, jcfg.d_model).astype(np.float32)
        jbatch["patches"], batch["patches"] = jnp.asarray(p), \
            torch.from_numpy(p)
    if jcfg.is_enc_dec:
        f = rng.randn(2, jcfg.encoder_seq_len, jcfg.d_model).astype(
            np.float32)
        jbatch["frames"], batch["frames"] = jnp.asarray(f), torch.from_numpy(f)
    want, wm = jax.jit(jmodel.loss)(params, jbatch)
    with torch.inference_mode():
        got, gm = port.loss(batch)
    np.testing.assert_allclose(float(got), float(want), **F32)
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), **F32)
