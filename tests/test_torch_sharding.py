"""The LM substrate's sharding rules and specs in the port against the JAX
package's.

Mirrors ``tests/test_sharding.py`` (the divisibility fallback, ``dp_axes``,
the MoE expert rule, every parameter's spec valid on both production
meshes, qwen mostly sharded), then holds, for all ten architectures at full
width (meta tensors on the port's side, ``jax.eval_shape`` on the
reference's, a mesh of shapes only on both), each parameter's spec equal to
the reference's ``param_pspec_tree`` spec with the stacked axes removed
(the port's names map to the reference's paths as ``convert`` maps them),
and the state, serving-parameter, batch and cache specs of every arch x
applicable shape.  Exact.  Also `shard_block` (a rank's rows of a dim
sharded over mesh dims) against the nested ``torch.chunk`` split that
DTensor's ``Shard`` makes.
"""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.distributed import sharding as JSH
from repro.distributed import specs as JSP
from repro.models import build_model as jbuild_model
from repro.optim import AdamW as JAdamW
from repro.train.step import TrainStepConfig as JTrainStepConfig
from repro_torch.configs import (ARCH_IDS, SHAPES, applicable_shapes,
                                 get_config)
from repro_torch.distributed import specs as SP
from repro_torch.distributed.sharding import (
    LMMesh, P, activation_dp_over_model, dp_axes, param_pspec_tree,
    pspec_for, reference_path, resolve_spec, shard_block)
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.train.step import TrainStepConfig

MESH = LMMesh((16, 16), ("data", "model"))
POD = LMMesh((2, 16, 16), ("pod", "data", "model"))


def ref_mesh(mesh):
    """The same mesh for the reference's rules (which read only these)."""
    return SimpleNamespace(axis_names=mesh.axis_names, shape=dict(mesh.shape),
                           size=mesh.size)


def leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def spec(s):
    return tuple(s)


def port_model(arch):
    return build_model(get_config(arch), "meta")


def ref_model(arch):
    return jbuild_model(jget_config(arch))


# ---------------------------------------------------------------------------
# mirrors of tests/test_sharding.py
# ---------------------------------------------------------------------------
def test_resolve_spec_divisibility_fallback():
    assert resolve_spec(("fsdp", "tensor"), (576, 576), MESH) \
        == P("data", "model")
    assert resolve_spec((None, "tensor"), (4, 9), MESH) == P(None, None)
    assert resolve_spec(("fsdp", "tensor"), (24, 576, 1536), MESH) \
        == P(None, "data", "model")


def test_dp_axes():
    assert dp_axes(MESH) == ("data",)
    assert dp_axes(POD) == ("pod", "data")


def test_moe_expert_rule():
    assert pspec_for("stack/moe/wi", (58, 256, 7168, 2048), MESH) \
        == P(None, "model", "data", None)
    assert pspec_for("stack/moe/wo", (58, 256, 2048, 7168), MESH) \
        == P(None, "model", None, "data")


def test_reference_path():
    assert reference_path("stack.3.attn.wq") == ("stack/attn/wq", (3,))
    assert reference_path("stack.1.mlstm.4.wq") == ("stack/mlstm/wq", (1, 4))
    assert reference_path("emb.w") == ("emb/w", ())


@pytest.mark.parametrize("arch", ["smollm-135m", "whisper-large-v3",
                                  "deepseek-v3-671b", "xlstm-350m",
                                  "zamba2-2.7b"])
def test_rules_valid_for_every_param(arch):
    params = dict(port_model(arch).named_parameters())
    for mesh in (MESH, POD):
        specs = param_pspec_tree(params, mesh)
        assert set(specs) == set(params)
        for name, p in params.items():
            for dim, ax in zip(p.shape, specs[name]):
                if ax is None:
                    continue
                axes = (ax,) if isinstance(ax, str) else ax
                prod = int(np.prod([mesh.shape[a] for a in axes]))
                assert dim % prod == 0, (arch, name, specs[name], p.shape)


def test_params_mostly_sharded_for_large_arch():
    params = dict(port_model("qwen1.5-110b").named_parameters())
    specs = param_pspec_tree(params, MESH)
    big_total = big_sharded = 0
    for name, p in params.items():
        n = p.numel()
        if n < 1e6:
            continue
        big_total += n
        if any(ax is not None for ax in specs[name]):
            big_sharded += n
    assert big_sharded / big_total > 0.999


# ---------------------------------------------------------------------------
# every spec against the reference's, all ten archs at full width
# ---------------------------------------------------------------------------
def check_params(port_specs, ref_specs, names):
    """Each port parameter's spec is the reference's spec of its stack with
    the stacked entries removed."""
    for name in names:
        path, idx = reference_path(name)
        want = spec(leaf(ref_specs, path))[len(idx):]
        assert spec(port_specs[name]) == want, (name, path)


@pytest.fixture(scope="module", params=ARCH_IDS)
def arch_pair(request):
    arch = request.param
    jmodel = ref_model(arch)
    jparams = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))
    return arch, jmodel, jparams, port_model(arch)


@pytest.mark.parametrize("mesh", [MESH, POD], ids=["16x16", "2x16x16"])
def test_param_and_state_specs_match_reference(arch_pair, mesh):
    arch, jmodel, jparams, model = arch_pair
    rm = ref_mesh(mesh)
    names = [n for n, _ in model.named_parameters()]
    params = SP.params_abstract(model)
    check_params(param_pspec_tree(params, mesh),
                 JSH.param_pspec_tree(jparams, rm), names)
    check_params(SP.params_pspecs(params, mesh, serving=True),
                 JSP.params_pspecs(jparams, rm, serving=True), names)
    state = SP.state_abstract(model, AdamW(), TrainStepConfig())
    jstate = JSP.state_abstract(jmodel, JAdamW(), JTrainStepConfig())
    ports, refs = SP.state_pspecs(state, mesh), JSP.state_pspecs(jstate, rm)
    check_params(ports["params"], refs["params"], names)
    for k in ("m", "v"):
        check_params(ports["opt"][k], refs["opt"][k], names)
    assert spec(ports["opt"]["count"]) == spec(refs["opt"]["count"]) == ()
    assert spec(ports["step"]) == spec(refs["step"]) == ()


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("mesh", [MESH, POD], ids=["16x16", "2x16x16"])
def test_batch_and_cache_specs_match_reference(arch_pair, mesh):
    arch, jmodel, _, model = arch_pair
    cfg, jcfg = get_config(arch), jget_config(arch)
    rm = ref_mesh(mesh)
    for sname in applicable_shapes(cfg):
        shape, jshape = SHAPES[sname], JSHAPES[sname]
        with activation_dp_over_model(cfg.dp_over_model), \
                JSH.activation_dp_over_model(jcfg.dp_over_model):
            batch = model.input_specs(shape)
            jbatch = jmodel.input_specs(jshape)
            assert {k: tuple(v.shape) for k, v in batch.items()} == \
                {k: tuple(v.shape) for k, v in jbatch.items()}
            got = SP.batch_pspecs(batch, mesh)
            want = JSP.batch_pspecs(jbatch, rm)
            assert {k: spec(v) for k, v in got.items()} == \
                {k: spec(v) for k, v in want.items()}, sname
            b = shape.global_batch
            cache = model.init_cache(b, shape.seq_len)
            jcache = jax.eval_shape(lambda: jmodel.init_cache(
                b, shape.seq_len))
            got = flat(SP.cache_pspecs(cache, mesh, batch_size=b,
                                       max_seq=shape.seq_len, cfg=cfg))
            want = flat(JSP.cache_pspecs(jcache, rm, batch_size=b,
                                         max_seq=shape.seq_len, cfg=jcfg))
            assert set(got) == set(want), sname
            for k in got:
                assert spec(got[k]) == spec(want[k]), (sname, k)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed.sharding import placements
    assert placements(P("data", "model"), MESH) == [Shard(0), Shard(1)]
    assert placements(P(None, "model", "data", None), MESH) \
        == [Shard(2), Shard(1)]
    assert placements(P(("pod", "data"), None), POD) \
        == [Shard(0), Shard(0), Replicate()]
    assert placements(P(), MESH) == [Replicate(), Replicate()]
    assert torch.empty(2, device="meta").is_meta


@pytest.mark.parametrize("n", [12, 7, 3, 1])
def test_shard_block_is_the_chunk_split(n):
    """A dim of ``n`` over mesh dims of sizes (2, 3), major first, uneven
    and empty blocks included: each rank's (first, length) is its nested
    ``torch.chunk`` block."""
    sizes = (2, 3)
    for r0 in range(2):
        for r1 in range(3):
            mesh = SimpleNamespace(size=sizes.__getitem__,
                                   get_local_rank=(r0, r1).__getitem__)
            first, length = shard_block(n, mesh, (0, 1))
            want = torch.arange(n)
            for r, m in ((r0, 2), (r1, 3)):
                parts = want.chunk(m)
                want = parts[r] if r < len(parts) else want[:0]
            assert list(range(first, first + length)) == want.tolist()
