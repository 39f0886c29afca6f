"""Every registered architecture of the port (``repro_torch.models``)
against the JAX package's, on the CPU at its ``reduced()`` config (B 2,
S 32), with the reference's parameters carried across by
``convert.lm_params_from_reference``.

Per architecture: ``forward``'s logits and aux in float32 (rtol 1e-4 /
atol 1e-4) and in bfloat16 (the reference's decode tolerance, rtol 0.05 /
atol 0.15; the MoE archs at ample capacity, held at every position whose
routing is no near tie, see ``test_forward_bfloat16``); the port's teacher-forced decode against its own forward (as
``test_models_smoke.py::test_smoke_decode_consistency``, bf16, rtol 0.05 /
atol 0.15); and the port's ``decode_step`` logits against the reference's,
step by step, in float32 within 1e-4.  The JAX side of an architecture runs
once (jitted) in a module-scoped fixture.
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
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import moe as M

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

B, S = 2, 32
DECODE_STEPS = 8
F32 = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=0.05, atol=0.15)
NEAR_TIE = 1e-2      # k-th minus (k+1)-th router score of a token
AMPLE_CAPACITY = 16.0


def make_batch(cfg, s=S, seed=0):
    """numpy inputs: tokens, and the VLM's patches / Whisper's frames."""
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (B, s)).astype(np.int32)}
    if cfg.n_image_patches:
        batch["patches"] = rng.randn(B, cfg.n_image_patches,
                                     cfg.d_model).astype(np.float32)
    if cfg.is_enc_dec:
        batch["frames"] = rng.randn(B, cfg.encoder_seq_len,
                                    cfg.d_model).astype(np.float32)
    return batch


def to_jax(batch, dtype):
    return {k: jnp.asarray(v) if k == "tokens" else jnp.asarray(v, dtype)
            for k, v in batch.items()}


def to_torch(batch, dtype):
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v).to(dtype) for k, v in batch.items()}


def reduced(get_config, arch, dtype):
    """``arch``'s reduced config in ``dtype``; in bf16 the MoE archs take
    ample capacity, so that a route flipped by rounding moves no other
    token's drop."""
    cfg = get_config(arch).reduced().replace(remat="nothing", dtype=dtype)
    if cfg.moe is not None and dtype == "bfloat16":
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=AMPLE_CAPACITY))
    return cfg


def jax_side(arch, dtype):
    cfg = reduced(jget_config, arch, dtype)
    model = jbuild_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return cfg, model, params


@pytest.fixture(scope="module", params=sorted(ARCH_IDS))
def ref(request):
    """The reference's float32 forward and step decode, and its bf16
    forward, with the parameters they ran on (numpy)."""
    arch = request.param
    out = {"arch": arch}
    for dt, jdt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        cfg, model, params = jax_side(arch, dt)
        batch = make_batch(cfg)
        logits, aux = jax.jit(model.forward)(params, to_jax(batch, jdt))
        out[dt] = dict(dtype=dt, batch=batch, logits=np.asarray(logits),
                       params=jax.tree_util.tree_map(np.asarray, params),
                       aux=float(aux))
    # float32 step decode, teacher-forced on the first DECODE_STEPS tokens
    cfg, model, params = jax_side(arch, "float32")
    batch = out["float32"]["batch"]
    tokens = batch["tokens"][:, :DECODE_STEPS]
    cache = model.init_cache(B, DECODE_STEPS)
    if cfg.is_enc_dec:
        _, c2 = model.prefill(params, to_jax(dict(batch, tokens=tokens),
                                             jnp.float32))
        cache = dict(cache, xk=c2["xk"], xv=c2["xv"])
    decode = jax.jit(model.decode_step)
    steps = []
    for i in range(DECODE_STEPS):
        logits, cache = decode(params, cache, jnp.asarray(tokens[:, i:i + 1]),
                               jnp.int32(i))
        steps.append(np.asarray(logits))
    out["decode"] = steps
    return out


def port_model(arch, side):
    """The port's model of ``arch`` holding the reference's parameters."""
    cfg = reduced(get_config, arch, side["dtype"])
    return cfg, lm_params_from_reference(cfg, side["params"], device="cpu")


def fill_cross_kv(model, cache, batch):
    """Whisper: the frozen cross K/V from ``prefill``, as the reference's
    decode test populates it."""
    _, c2 = model.prefill(batch)
    cache["xk"].copy_(c2["xk"])
    cache["xv"].copy_(c2["xv"])


def test_forward_float32(ref):
    side = ref["float32"]
    cfg, model = port_model(ref["arch"], side)
    with torch.inference_mode():
        logits, aux = model(to_torch(side["batch"], torch.float32))
    expect_seq = S + (cfg.n_image_patches or 0)
    assert tuple(logits.shape) == (B, expect_seq, cfg.vocab_size)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), side["logits"], **F32)
    np.testing.assert_allclose(float(aux), side["aux"], **F32)


def test_forward_bfloat16(ref, monkeypatch):
    """bf16 logits within the reference's decode tolerance.  XLA's and
    torch's fp32-accumulated GEMMs round to bf16 apart now and then, so a
    MoE token whose k-th and (k+1)-th router scores lie within NEAR_TIE in
    some layer may take another expert: such positions are reported, and
    every other one is held.  (The MoE layer alone is bitwise the
    reference's in bf16, ``test_torch_lm_layers.py``.)"""
    side = ref["bfloat16"]
    cfg, model = port_model(ref["arch"], side)
    assert model.emb.w.dtype == torch.bfloat16
    margins = []
    route = M.route

    def recording(p, c, x, seq=None):
        k = c.moe.n_experts_per_tok
        top = torch.sigmoid(x.float() @ p.router).topk(k + 1).values
        margins.append((top[:, k - 1] - top[:, k]).view(B, -1))
        return route(p, c, x, seq)

    monkeypatch.setattr(M, "route", recording)
    with torch.inference_mode():
        logits, aux = model(to_torch(side["batch"], torch.bfloat16))
    assert torch.isfinite(logits).all()
    held = np.ones(logits.shape[:2], bool)
    if margins:
        held = torch.stack(margins).amin(0).numpy() >= NEAR_TIE
        print(f"{ref['arch']}: near-tie routes at (row, position) "
              f"{[tuple(map(int, i)) for i in np.argwhere(~held)]}")
        assert held.mean() >= 0.75
    np.testing.assert_allclose(logits.numpy()[held], side["logits"][held],
                               **DECODE_TOL)
    np.testing.assert_allclose(float(aux), side["aux"], **DECODE_TOL)


def test_decode_steps_match_reference(ref):
    """The port's decode_step logits against the reference's, step by step
    (float32), from the same tokens and the same empty cache."""
    side = ref["float32"]
    cfg, model = port_model(ref["arch"], side)
    batch = to_torch(side["batch"], torch.float32)
    tokens = batch["tokens"][:, :DECODE_STEPS]
    cache = model.init_cache(B, DECODE_STEPS)
    if cfg.is_enc_dec:
        fill_cross_kv(model, cache, dict(batch, tokens=tokens))
    for i in range(DECODE_STEPS):
        logits, cache2 = model.decode_step(cache, tokens[:, i:i + 1], i)
        assert cache2 is cache
        assert tuple(logits.shape) == (B, 1, cfg.vocab_size)
        np.testing.assert_allclose(logits.numpy(), ref["decode"][i], **F32,
                                   err_msg=f"step {i}")


def test_decode_consistency(ref):
    """Teacher-forced decode reproduces the port's own forward at the last
    position (bf16, the reference's tolerance).  The VLM runs without
    patches (an empty [B, 0, D] prefix): decode takes no image."""
    side = ref["bfloat16"]
    cfg, model = port_model(ref["arch"], side)
    s = DECODE_STEPS
    batch = to_torch(side["batch"], torch.bfloat16)
    batch["tokens"] = batch["tokens"][:, :s]
    if cfg.n_image_patches:
        batch["patches"] = batch["patches"][:, :0]
    if cfg.is_enc_dec:
        batch["frames"] = torch.zeros_like(batch["frames"])
    with torch.inference_mode():
        full, _ = model(batch)
    cache = model.init_cache(B, s)
    if cfg.is_enc_dec:
        fill_cross_kv(model, cache, batch)
    for i in range(s):
        step, cache = model.decode_step(cache, batch["tokens"][:, i:i + 1], i)
    np.testing.assert_allclose(step[:, 0].numpy(), full[:, -1].numpy(),
                               **DECODE_TOL)
