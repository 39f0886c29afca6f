"""Every registered architecture's training path in the port against the JAX
package's, on the CPU at its ``reduced()`` config in float32 (remat off,
B 2, S 32), with the reference's parameters carried across by
``convert.lm_params_from_reference``.

Per architecture: ``loss`` and its metrics within 1e-5 of
``jax.value_and_grad(model.loss)``; every gradient leaf within rtol 1e-4 /
atol 1e-5 of the reference's, mapped by parameter name; one whole
``make_train_step`` step (AdamW at lr 1e-3) against the reference's, its
parameters held to rtol 1e-4 / atol 1e-5, except where the reference's
|g| lies within the gradient tolerance of 0 (there the first AdamW step,
about lr * sign(g), may move the other way: atol 2 lr); and the remat
policies 'dots' and 'full' give gradients bitwise equal to 'nothing'.
The JAX side of an architecture runs once (one jitted function) in a
module-scoped fixture.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.optim import AdamW as JAdamW
from repro.train.step import TrainStepConfig as JTrainStepConfig
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.optim import AdamW
from repro_torch.train.step import TrainStepConfig, make_train_step

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

B, S = 2, 32
LR = 1e-3
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def reduced(get_config, arch):
    return get_config(arch).reduced().replace(remat="nothing",
                                              dtype="float32")


def make_batch(cfg, seed=0):
    rng = np.random.RandomState(seed)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.n_image_patches:
        batch["patches"] = rng.randn(B, cfg.n_image_patches,
                                     cfg.d_model).astype(np.float32)
    if cfg.is_enc_dec:
        batch["frames"] = rng.randn(B, cfg.encoder_seq_len,
                                    cfg.d_model).astype(np.float32)
    return batch


def to_torch(batch):
    return {k: torch.from_numpy(v).long() if k in ("tokens", "labels")
            else torch.from_numpy(v) for k, v in batch.items()}


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def ref_leaf(flat, name):
    """The reference's slice for the port's parameter ``name``
    (``stack.3.attn.wq`` -> ``stack/attn/wq`` [3])."""
    parts = name.split(".")
    idx = tuple(int(x) for x in parts if x.isdigit())
    return flat["/".join(x for x in parts if not x.isdigit())][idx]


@pytest.fixture(scope="module", params=sorted(ARCH_IDS))
def ref(request):
    """The reference's loss, metrics and gradients, and its parameters after
    one ``make_train_step`` step, from one jitted function."""
    arch = request.param
    cfg = reduced(jget_config, arch)
    model = jbuild_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    batch = make_batch(cfg)
    opt = JAdamW()
    train_step = jmake_train_step(model, opt,
                                  JTrainStepConfig(learning_rate=LR))

    def run(params, batch):
        (loss, metrics), grads = jax.value_and_grad(
            model.loss, has_aux=True)(params, batch)
        state = {"params": params, "opt": opt.init(params),
                 "step": jnp.zeros((), jnp.int32)}
        new_state, step_metrics = train_step(state, batch)
        return loss, metrics, grads, new_state["params"], step_metrics

    out = jax.jit(run)(params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads, new_params, step_metrics = jax.tree_util.tree_map(
        np.asarray, out)
    return dict(arch=arch, batch=batch, loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                params=jax.tree_util.tree_map(np.asarray, params),
                grads=_flatten(grads), new_params=_flatten(new_params),
                step_metrics={k: float(v) for k, v in step_metrics.items()})


def port_grads(ref, remat="nothing"):
    cfg = reduced(get_config, ref["arch"]).replace(remat=remat)
    model = lm_params_from_reference(cfg, ref["params"], device="cpu")
    loss, metrics = model.loss(to_torch(ref["batch"]))
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    return model, loss, metrics, dict(zip(params, grads))


def test_loss_and_grads(ref):
    model, loss, metrics, grads = port_grads(ref)
    np.testing.assert_allclose(float(loss.detach()), ref["loss"], **LOSS_TOL)
    assert set(metrics) == set(ref["metrics"])
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v.detach()), ref["metrics"][k],
                                   **LOSS_TOL, err_msg=k)
    for name, g in grads.items():
        want = ref_leaf(ref["grads"], name)
        assert tuple(g.shape) == want.shape, name
        assert bool(torch.isfinite(g).all()), name
        np.testing.assert_allclose(g.numpy(), want, **GRAD_TOL, err_msg=name)


def test_train_step(ref):
    cfg = reduced(get_config, ref["arch"])
    model = lm_params_from_reference(cfg, ref["params"], device="cpu")
    opt = AdamW()
    params = dict(model.named_parameters())
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    before = {k: p.detach().clone() for k, p in params.items()}
    state, metrics = make_train_step(model, opt, TrainStepConfig(
        learning_rate=LR))(state, to_torch(ref["batch"]))
    assert int(state["step"]) == 1
    for k, v in ref["step_metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), v, **LOSS_TOL,
                                   err_msg=k)
    changed, near_zero = 0, 0
    for name, p in state["params"].items():
        got = p.detach().numpy()
        want = ref_leaf(ref["new_params"], name)
        g = np.abs(ref_leaf(ref["grads"], name))
        flip = g <= GRAD_TOL["atol"] + GRAD_TOL["rtol"] * g
        near_zero += int(flip.sum())
        np.testing.assert_allclose(got[~flip], want[~flip], **GRAD_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(got[flip], want[flip], rtol=0,
                                   atol=2 * LR, err_msg=name)
        changed += bool((p != before[name]).any())
    print(f"{ref['arch']}: {near_zero} elements held at atol 2 lr")
    assert changed, "no parameter changed"


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_grads_bitwise(ref, remat, monkeypatch):
    """Each layer (each super-layer of xLSTM and Zamba) runs under
    ``checkpoint``, and the gradients are those without it, bit for bit."""
    from repro_torch.models import blocks as Bk
    calls = []
    wrapped = Bk.checkpoint

    def counting(fn, *args, **kw):
        calls.append(type(fn).__name__)
        return wrapped(fn, *args, **kw)

    _, loss0, _, want = port_grads(ref)
    assert not calls
    monkeypatch.setattr(Bk, "checkpoint", counting)
    _, loss, _, got = port_grads(ref, remat)
    cfg = reduced(get_config, ref["arch"])
    n = cfg.n_layers + cfg.n_encoder_layers
    if cfg.xlstm is not None:
        n = cfg.n_layers // cfg.xlstm.slstm_every
    elif cfg.shared_attn_every:
        n = cfg.n_layers // cfg.shared_attn_every
    assert len(calls) == n, calls
    assert torch.equal(loss, loss0)
    for name, g in got.items():
        assert torch.equal(g, want[name]), name
