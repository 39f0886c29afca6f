"""The LM substrate's optimizer and train step in the port
(``repro_torch.optim``, ``repro_torch.train``) against the JAX package, on
the CPU.

``clip_by_global_norm``, ``AdamW.update``, ``cosine_schedule`` and
``compress_decompress`` run on the same numpy grads, params and states as
the reference's: float32 within rtol 1e-6 (atol 1e-9 where a value is near
0); bfloat16 bitwise or within one bf16 ulp, the elements an ulp apart
counted and printed.  The train step's behaviour mirrors
``tests/test_train_serve.py`` (loss falls, 2 microbatches against 1,
error feedback), and the card's fp32-output GEMM's backward
(``layers.MatmulF32``) is held to autograd of the CPU's upcast route.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamW as JAdamW
from repro.optim import clip_by_global_norm as jclip
from repro.optim import compress_decompress as jcompress
from repro.optim import cosine_schedule as jcosine
from repro_torch.configs import get_config
from repro_torch.data.tokens import synthetic_lm_batch
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.optim import (AdamW, clip_by_global_norm,
                               compress_decompress, cosine_schedule)
from repro_torch.train.step import (TrainStepConfig, make_init_fn,
                                    make_train_step)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

F32 = dict(rtol=1e-6, atol=1e-9)
SHAPES = {"w": (24, 40), "experts": (3, 16, 8), "scale": (40,), "b": (7,)}
LR = 3e-3


def _tree(seed, scale=1.0, shapes=SHAPES):
    rng = np.random.RandomState(seed)
    return {k: (scale * rng.randn(*s)).astype(np.float32)
            for k, s in shapes.items()}


def _torch(tree, dtype):
    return {k: torch.from_numpy(v.copy()).to(dtype) for k, v in tree.items()}


def _jax(tree, dtype):
    return {k: jnp.asarray(v, dtype) for k, v in tree.items()}


def _bits(x):
    """int32 view of a bf16 / f32 value's bits (numpy from either side)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().astype(np.int32)
        return x.numpy().view(np.int32)
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16).astype(np.int32)
    return a.view(np.int32)


def assert_close(got, want, dtype, what):
    """float32: rtol 1e-6; bfloat16: bitwise or one ulp (same sign), the
    count of elements an ulp apart printed."""
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   **F32, err_msg=what)
        return
    diff = np.abs(_bits(got) - _bits(want))
    print(f"{what}: {int((diff > 0).sum())} of {diff.size} bf16 elements one "
          f"ulp from the reference's")
    assert diff.max() <= 1, f"{what}: {int(diff.max())} ulps apart"


DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                                 ids=["float32", "bfloat16"])


@DTYPES
@pytest.mark.parametrize("scale", [0.01, 1.0], ids=["unclipped", "clipped"])
def test_clip_by_global_norm(dtype, scale):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    grads = _tree(0, scale)
    got, gn = clip_by_global_norm(_torch(grads, dtype), 1.0)
    want, jgn = jclip(_jax(grads, jdt), 1.0)
    np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
    assert (float(gn) > 1.0) == (scale == 1.0)
    for k in grads:
        assert got[k].dtype == dtype
        assert_close(got[k], want[k], dtype, f"clipped {k}")


@DTYPES
@pytest.mark.parametrize("count", [0, 5])
def test_adamw_update(dtype, count):
    """One update from a state of random moments at ``count`` (1-D leaves
    take no weight decay), against the reference's on the same arrays."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    params, grads = _tree(1), _tree(2, 0.5)
    m = _tree(3, 0.1) if count else {k: np.zeros_like(v)
                                     for k, v in params.items()}
    v = ({k: np.abs(x) for k, x in _tree(4, 0.01).items()} if count
         else {k: np.zeros_like(x) for k, x in params.items()})
    opt, jopt = AdamW(), JAdamW()
    state = {"m": _torch(m, torch.float32), "v": _torch(v, torch.float32),
             "count": torch.tensor(count, dtype=torch.int32)}
    jstate = {"m": _jax(m, jnp.float32), "v": _jax(v, jnp.float32),
              "count": jnp.int32(count)}
    p = _torch(params, dtype)
    new_p, new_state, gn = opt.update(_torch(grads, dtype), state, p, LR)
    jp, jst, jgn = jopt.update(_jax(grads, jdt), jstate, _jax(params, jdt),
                               LR)
    np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-6)
    assert int(new_state["count"]) == int(jst["count"]) == count + 1
    for k in params:
        assert new_p[k] is p[k] and new_p[k].dtype == dtype
        assert_close(new_p[k], jp[k], dtype, f"param {k}")
        for mom in ("m", "v"):
            assert new_state[mom][k].dtype == torch.float32
            np.testing.assert_allclose(new_state[mom][k].numpy(),
                                       np.asarray(jst[mom][k]), **F32,
                                       err_msg=f"{mom} {k}")


def test_adamw_slabs_change_no_bit(monkeypatch):
    """A tensor updated a slab at a time equals the whole-tensor update."""
    from repro_torch.optim import adamw
    params, grads = _tree(5), _tree(6)
    runs = []
    for slab in (adamw.SLAB, 7):
        monkeypatch.setattr(adamw, "SLAB", slab)
        opt = AdamW()
        p = _torch(params, torch.bfloat16)
        state = opt.init(p)
        for _ in range(2):
            opt.update(_torch(grads, torch.bfloat16), state, p, LR)
        runs.append((p, state))
    for k in params:
        assert torch.equal(runs[0][0][k], runs[1][0][k])
        assert torch.equal(runs[0][1]["v"][k], runs[1][1]["v"][k])


def test_cosine_schedule():
    lr, jlr = cosine_schedule(3e-3, 20, 100), jcosine(3e-3, 20, 100)
    steps = np.arange(0, 120, dtype=np.int32)
    got = np.array([float(lr(torch.tensor(s))) for s in steps], np.float32)
    want = np.asarray(jax.vmap(jlr)(jnp.asarray(steps)))
    np.testing.assert_allclose(got, want, **F32)
    assert float(lr(0)) == 0.0                  # step 0 of the warm-up
    assert lr(torch.tensor(5, dtype=torch.int32)).dtype == torch.float32
    np.testing.assert_allclose(float(lr(20)), 3e-3, rtol=1e-6)
    np.testing.assert_allclose(float(lr(100)), 3e-4, rtol=1e-6)


@DTYPES
def test_compress_decompress(dtype):
    """Two rounds of int8 compression with error feedback."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    err, jerr = None, None
    for seed in (7, 8):
        g = _tree(seed, 0.3)
        deq, err = compress_decompress(_torch(g, dtype), err)
        jdeq, jerr = jcompress(_jax(g, jdt), jerr)
        for k in g:
            assert deq[k].dtype == dtype and err[k].dtype == torch.float32
            assert_close(deq[k], jdeq[k], dtype, f"dequantized {k}")
            np.testing.assert_allclose(err[k].numpy(), np.asarray(jerr[k]),
                                       rtol=1e-6, atol=1e-7)
    assert any(float(e.abs().sum()) > 0 for e in err.values())


@pytest.mark.parametrize("batched", [False, True], ids=["mm", "bmm"])
def test_matmul_f32_backward(batched):
    """``MatmulF32``'s backward (the card's route) against autograd of the
    CPU's upcast route, bf16 operands: equal grads, rounded once to bf16."""
    rng = np.random.RandomState(9)
    lead = (3,) if batched else ()
    a0 = torch.from_numpy(rng.randn(*lead, 12, 32).astype(np.float32))
    b0 = torch.from_numpy(rng.randn(*lead, 32, 20).astype(np.float32))
    cot = torch.from_numpy(rng.randn(*lead, 12, 20).astype(np.float32))
    a, b = (t.bfloat16().requires_grad_() for t in (a0, b0))
    out = L.MatmulF32.apply(a, b)
    assert out.dtype == torch.float32
    ga, gb = torch.autograd.grad(out, (a, b), cot)
    a2, b2 = (t.bfloat16().requires_grad_() for t in (a0, b0))
    mm = torch.bmm if batched else torch.mm
    ref = mm(a2.float(), b2.float())
    wa, wb = torch.autograd.grad(ref, (a2, b2), cot)
    assert torch.equal(out, ref)
    assert ga.dtype == gb.dtype == torch.bfloat16
    assert torch.equal(ga, wa) and torch.equal(gb, wb)
    # only the operand that needs a grad gets one
    w = b0.bfloat16().requires_grad_()
    (g_only,) = torch.autograd.grad(L.MatmulF32.apply(a0.bfloat16(), w),
                                    (w,), cot)
    assert torch.equal(g_only, wb)


# ---- the train step (as tests/test_train_serve.py) -------------------------
def setup(arch="smollm-135m", **step_kw):
    cfg = get_config(arch).reduced().replace(remat="nothing")
    model = build_model(cfg, device="cpu")
    opt = AdamW()
    scfg = TrainStepConfig(**step_kw)
    state = make_init_fn(model, opt, scfg)(torch.Generator().manual_seed(0))
    return cfg, model, state, make_train_step(model, opt, scfg)


def lm_batch(b, s, vocab, seed):
    return {k: torch.from_numpy(v).long()
            for k, v in synthetic_lm_batch(b, s, vocab, seed=seed).items()}


def test_loss_decreases():
    cfg, model, state, step = setup(learning_rate=3e-3)
    losses = []
    for i in range(25):
        state, m = step(state, lm_batch(4, 64, cfg.vocab_size, i))
        losses.append(float(m["loss"]))
    assert int(state["step"]) == 25 and int(state["opt"]["count"]) == 25
    assert set(m) == {"loss", "ce", "aux", "z", "grad_norm", "lr"}
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2


def test_microbatch_equivalence():
    """2 microbatches must match the single-batch gradient step closely;
    the accumulated gradient is the mean of the two halves' gradients.
    A first AdamW step moves an element by about lr * sign(g), so an element
    whose two gradients (bf16 over the batch; the fp32 mean of two bf16
    halves) take opposite signs moves 2 lr apart: such elements are held
    to lie within the gradients' difference of 0, and to 2 lr."""
    lr = 1e-3
    cfg, model1, state1, step1 = setup(learning_rate=lr, microbatches=1)
    _, model2, state2, step2 = setup(learning_rate=lr, microbatches=2)
    batch = lm_batch(4, 32, cfg.vocab_size, 0)
    w = model1.emb.w                         # the reference test's leaf
    (g1,) = torch.autograd.grad(model1.loss(batch)[0], (w,))
    g2 = sum(torch.autograd.grad(model1.loss({k: v[i:i + 2] for k, v in
                                              batch.items()})[0], (w,))[0]
             .float() for i in (0, 2)) / 2
    s1, m1 = step1(state1, batch)
    s2, m2 = step2(state2, batch)
    # CE is averaged over the same tokens either way
    assert abs(float(m1["ce"]) - float(m2["ce"])) < 0.05
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    # the grads are bf16 in one step, fp32 sums of two bf16 halves in the
    # other: their norms agree to bf16's precision
    np.testing.assert_allclose(float(m1["grad_norm"]), float(m2["grad_norm"]),
                               rtol=1e-2)
    w1 = s1["params"]["emb.w"].detach().float().numpy()
    w2 = s2["params"]["emb.w"].detach().float().numpy()
    g1 = g1.float().numpy()
    g2 = g2.numpy()
    flip = np.sign(g1) != np.sign(g2)
    gdiff = float(np.abs(g1 - g2).max())
    print(f"{int(flip.sum())} of {flip.size} elements' gradients change "
          f"sign; max |g| there {np.abs(g1[flip]).max(initial=0):.3g}, the "
          f"gradients within {gdiff:.3g}")
    assert np.abs(g1[flip]).max(initial=0) <= gdiff
    np.testing.assert_allclose(w1[~flip], w2[~flip], rtol=0.1, atol=1e-3)
    np.testing.assert_allclose(w1[flip], w2[flip], rtol=0.1, atol=2.2 * lr)


def test_grad_compression_error_feedback():
    cfg, model, state, step = setup(learning_rate=1e-3,
                                    grad_compression=True)
    assert "err" in state
    assert all(e.dtype == torch.float32 for e in state["err"].values())
    state, m = step(state, lm_batch(2, 32, cfg.vocab_size, 0))
    assert bool(torch.isfinite(m["loss"]))
    # error buffers are non-zero after one step (feedback captured)
    assert sum(float(e.abs().sum()) for e in state["err"].values()) > 0.0


def test_mamba2_decay_masked_before_the_exp():
    """The SSD scan masks the intra-chunk log-decay before the exp: the
    forward is bitwise that of masking after it (the reference's form), and
    the gradient stays finite where the upper triangle's exp overflows
    (chunk 64, strong decay), which the reference's form turns into NaN."""
    from repro_torch.models import ssm as S
    rng = np.random.RandomState(10)
    b, s, h, p, n = 2, 64, 3, 4, 8
    x, B_, C_ = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                 for shape in ((b, s, h, p), (b, s, n), (b, s, n)))
    dt = torch.from_numpy(rng.uniform(0.5, 2.0, (b, s, h)).astype(
        np.float32)).requires_grad_()
    A = -torch.tensor([1.0, 8.0, 16.0])

    def masked_after(x, dt, A, B, C, chunk):
        q = chunk
        mask = torch.tril(torch.ones((q, q), dtype=torch.bool))
        dA = dt * A
        cum = torch.cumsum(dA, dim=1)
        li = cum[:, :, None, :] - cum[:, None, :, :]
        decay = torch.exp(li).masked_fill(~mask[None, :, :, None], 0.0)
        cb = torch.einsum("bin,bjn->bij", C, B)
        return torch.einsum("bij,bijh,bjhp->bihp", cb, decay,
                            x * dt[..., None])

    got = S._ssd_chunked(x, dt, A, B_, C_, s)
    want = masked_after(x, dt, A, B_, C_, s)
    assert torch.equal(got, want)           # one chunk: no carried state
    (g,) = torch.autograd.grad(got.sum(), (dt,))
    (g_after,) = torch.autograd.grad(want.sum(), (dt,))
    assert bool(torch.isfinite(g).all())
    assert not bool(torch.isfinite(g_after).all())
