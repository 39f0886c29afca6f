"""The LM substrate's analysis in the port: the dry run's per-rank counter,
its roofline arithmetic against the JAX package's, ``lower_cell`` on fake
meshes, and the depth correction.

Mirrors ``tests/test_analysis_mode.py::test_single_chunk_flag_scoped`` and
``test_largest_divisible_prefix``; holds ``roofline_terms``,
``model_flops`` and ``active_param_count`` to the reference's on the same
inputs (the port's function at the reference's constants: the constants
are the H100's here, the TPU's there); counts a ``[Shard, Shard]`` mm on a
fake 16 x 16 mesh at the global count over the shard product; traces
reduced configs' train, prefill and decode on fake meshes of 4 and 16 ranks
(every key of the reference's JSON, FLOPs and collectives above 0); and
holds ``correct_cell``'s extrapolation equal to the direct full-depth count
for a reduced dense, MoE, xLSTM and Zamba config; and traces a reduced MoE
prefill on (4, 1) and (2, 2) to show that the MoE layer keeps the
reference's layout on a rank: no tensor larger than its own pairs [T*k/dp,
d] or its own experts' buffers [E/ep, C + 1, max(d, ff)], and the experts'
FFN in the reference's [E/ep, C, ff] (C never split; g and u split on K
over ``data`` as the reference's module splits them, their fp32 partials
summed before they are read; wo's output split on d over ``data``).  No
card is needed.
"""
import contextlib
import dataclasses
import json
import os

import pytest
import torch

from repro.launch import analysis as JA
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.distributed.sharding import (P, LMMesh,
                                              largest_divisible_prefix,
                                              placements)
from repro_torch.launch import analysis as A
from repro_torch.launch import dryrun as D
from repro_torch.launch.correction import correct_cell, stack_knobs
from repro_torch.launch.dryrun import lower_cell, rank0_shard
from repro_torch.launch.mesh import make_fake_mesh, release_mesh
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.analysis_flags import (card_routes,
                                               card_routes_active,
                                               single_chunk,
                                               single_chunk_active)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

TRAIN = ShapeConfig("t", 32, 4, "train")
PREFILL = ShapeConfig("p", 32, 4, "prefill")
DECODE = ShapeConfig("d", 32, 4, "decode")


@contextlib.contextmanager
def fake_mesh(shape):
    mesh = make_fake_mesh(shape, ("data", "model"))
    try:
        yield mesh
    finally:
        release_mesh()


def test_single_chunk_flag_scoped():
    assert not single_chunk_active()
    with single_chunk():
        assert single_chunk_active()
    assert not single_chunk_active()
    assert not card_routes_active()
    with card_routes():
        assert card_routes_active()
    assert not card_routes_active()


def test_largest_divisible_prefix():
    m = LMMesh((16, 16), ("data", "model"))
    assert largest_divisible_prefix(256, ("data", "model"), m) \
        == ("data", "model")
    assert largest_divisible_prefix(32, ("data", "model"), m) == "data"
    assert largest_divisible_prefix(7, ("data", "model"), m) is None
    assert largest_divisible_prefix(128, ("data", "model"), m) == "data"


@pytest.mark.parametrize("flops,hbm,coll", [
    (1e15, 1e12, 1e10), (3e12, 8e11, 0.0), (0.0, 0.0, 0.0), (5e13, 1e9, 1e11)])
def test_roofline_terms_match_reference(monkeypatch, flops, hbm, coll):
    monkeypatch.setattr(A, "PEAK_FLOPS", JA.PEAK_FLOPS)
    monkeypatch.setattr(A, "HBM_BW", JA.HBM_BW)
    monkeypatch.setattr(A, "LINK_BW", JA.ICI_BW)
    assert A.roofline_terms(flops, hbm, coll, 256) \
        == JA.roofline_terms(flops, hbm, coll, 256)


def test_h100_constants():
    assert (A.PEAK_FLOPS, A.HBM_BW, A.LINK_BW) == (989e12, 3.35e12, 50e9)
    assert A.CARD == "NVIDIA H100 80GB HBM3, 700 W"


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-v3-671b",
                                  "dbrx-132b", "zamba2-2.7b"])
def test_model_flops_and_active_params_match_reference(arch):
    from repro.configs import get_config as jget_config
    cfg, jcfg = get_config(arch), jget_config(arch)
    for n in (10**9, 671 * 10**9):
        assert A.active_param_count(cfg, n) == JA.active_param_count(jcfg, n)
        for kind in ("train", "serve"):
            assert A.model_flops(n, 4096, kind) == \
                JA.model_flops(n, 4096, kind)


def test_sharded_mm_counts_per_rank():
    """A [Shard(0), Shard(1)] x [Shard(0), Shard(1)] mm on the fake 16 x 16
    mesh: the rank's count is the global count over the shard product (256),
    and DTensor's all-gathers are counted in bytes of their results."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Shard
    with fake_mesh((16, 16)) as mesh, FakeTensorMode():
        pls = placements(P("data", "model"), mesh)
        a = rank0_shard(torch.empty(4096, 8192), pls, mesh)
        b = rank0_shard(torch.empty(8192, 1024), pls, mesh)
        assert a.placements == (Shard(0), Shard(1))
        with A.OpCounter() as c:
            a @ b
    assert c.flops == 2 * 4096 * 8192 * 1024 / 256
    assert c.collectives["all-gather"] > 0


KEYS = {"arch", "shape", "mesh", "n_chips", "n_params", "n_active_params",
        "microbatches", "lower_s", "compile_s", "memory", "cost",
        "collective_bytes", "collective_bytes_total", "model_flops",
        "useful_flops_ratio", "roofline", "peak_tensors"}


@pytest.mark.parametrize("mesh_shape", [(2, 2), (4, 4)], ids=["4", "16"])
def test_lower_cell_keys(mesh_shape):
    cfg = get_config("smollm-135m").reduced()
    moe = get_config("deepseek-v3-671b").reduced()
    with fake_mesh(mesh_shape) as mesh:
        cells = [(cfg, TRAIN, 2), (cfg, PREFILL, 1), (cfg, DECODE, 1),
                 (moe, TRAIN, 1)]
        for c, shape, mb in cells:
            r = lower_cell(c, shape, mesh, microbatches=mb)
            assert KEYS <= set(r), KEYS - set(r)
            assert set(r["memory"]) == {"argument_bytes", "output_bytes",
                                        "temp_bytes",
                                        "peak_bytes_per_device"}
            assert set(r["roofline"]) == {"compute_s", "memory_s",
                                          "collective_s", "dominant",
                                          "roofline_fraction"}
            assert r["cost"]["hlo_flops"] > 0 and r["cost"]["hlo_bytes"] > 0
            assert r["collective_bytes_total"] > 0
            assert r["memory"]["peak_bytes_per_device"] \
                >= r["memory"]["argument_bytes"] > 0
            assert 0 < sum(b for b, _, _ in r["peak_tensors"]) \
                <= r["memory"]["peak_bytes_per_device"]
            assert r["n_chips"] == mesh.size
            assert r["mesh"] == "x".join(map(str, mesh_shape))
            json.dumps(r)


def _deeper(cfg, counts):
    return stack_knobs(cfg)[2](counts)


@pytest.mark.parametrize("arch,counts,shape", [
    ("internlm2-1.8b", (4,), TRAIN),
    ("deepseek-v3-671b", (2, 3), TRAIN),
    ("xlstm-350m", (3,), PREFILL),
    ("zamba2-2.7b", (3,), PREFILL)])
def test_correction_equals_direct_count(tmp_path, arch, counts, shape):
    cfg = _deeper(get_config(arch).reduced(), counts)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=0.5))
    with fake_mesh((2, 2)) as mesh:
        path = tmp_path / "cell.json"
        path.write_text(json.dumps(lower_cell(cfg, shape, mesh)))
        d = correct_cell(path, mesh, cfg=cfg, shape=shape)
    assert d["corrected"]["full"] == list(counts)
    assert d["corrected"]["equals_direct"] == [True, True, True], \
        (d["corrected"], d["cost"], d["collective_bytes_total"])


@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
def test_moe_holds_only_its_own_pairs(monkeypatch, mesh_shape):
    """The reference shards the MoE's pairs over the data axes and its
    expert buffers over ``model`` (``src/repro/models/moe.py:91-116``): a
    rank's largest MoE tensors are [T*k/dp, d] and [E/ep, C, max(d, ff)]
    (+ the spare row), never the global tokens' [T*k, d] pairs."""
    cfg = get_config("deepseek-v3-671b").reduced()
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    shape = ShapeConfig("p", 32, 8, "prefill")
    m, d = cfg.moe, cfg.d_model
    t = shape.global_batch * shape.seq_len
    dp, ep = mesh_shape
    bound = max(t * m.n_experts_per_tok // dp * d,
                m.n_experts // ep * (M.capacity(cfg, t) + 1)
                * max(d, m.d_ff_expert))
    assert t * m.n_experts_per_tok * d > bound     # the global pairs show
    inside, sizes = [0], []

    class Sizes(A.OpCounter):
        def track(self, x):
            super().track(x)
            if inside[0] and x.is_floating_point():
                sizes.append((x.numel(), tuple(x.shape)))

    forward = M.MoE.forward

    def counted(self, x):
        inside[0] += 1
        try:
            return forward(self, x)
        finally:
            inside[0] -= 1

    monkeypatch.setattr(M.MoE, "forward", counted)
    monkeypatch.setattr(D, "OpCounter", Sizes)
    with fake_mesh(mesh_shape) as mesh:
        lower_cell(cfg, shape, mesh)
    assert sizes
    assert max(sizes)[0] <= bound, (max(sizes), bound)


@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
def test_moe_ffn_keeps_the_reference_layout(monkeypatch, mesh_shape):
    """The reference pins the experts' [E, C, d] buffers to E over
    ``model`` and never splits C (``src/repro/distributed/sharding.py:
    199-201``), and its partitioned module of this chunked prefill (a
    chunk's C 8) splits the experts' products over ``data`` as the
    weights' ``fsdp`` split lies: g and u contract over the ``data`` split
    of d ([E/ep, 8, d/dp] x [E/ep, d/dp, ff], fp32 partials summed over
    ``data``) and wo's output keeps d split over ``data`` ([E/ep, 8, ff] x
    [E/ep, ff, d/dp]).  On a rank g, u and h are [E/ep, C, ff] (``C`` = the
    8 chunks' capacities), g's and u's products are partial over
    ``data`` alone, summed before they are read, and wo's is split on d
    over ``data``: no weight is gathered."""
    from torch.distributed.tensor import Partial, Shard
    cfg = get_config("deepseek-v3-671b").reduced()
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    shape = ShapeConfig("p", 32, 8, "prefill")
    m, nc = cfg.moe, cfg.prefill_chunks
    t = shape.global_batch * shape.seq_len
    c = nc * M.capacity(cfg, t // nc)
    dp, ep = mesh_shape
    ffn = (m.n_experts // ep, c, m.d_ff_expert)
    calls, plans = [], []
    bmatmul, mm_plan = L.bmatmul, L._mm_plan

    def planned(*args, **kwargs):
        plans.append(mm_plan(*args, **kwargs))
        return plans[-1]

    def recorded(a, b, *args):
        del plans[:]
        out = bmatmul(a, b, *args)
        if hasattr(out, "to_local"):
            calls.append((tuple(a.to_local().shape),
                          tuple(out.to_local().shape),
                          tuple(p[2] for p in plans),
                          any(p.is_partial() for p in out.placements)))
        return out

    monkeypatch.setattr(L, "bmatmul", recorded)
    monkeypatch.setattr(L, "_mm_plan", planned)
    with fake_mesh(mesh_shape) as mesh:
        lower_cell(cfg, shape, mesh)
    n_moe = cfg.n_layers - m.n_dense_layers
    assert len(calls) == 3 * n_moe, calls
    for i in range(0, len(calls), 3):
        (_, g, pg, _), (_, u, pu, _), (h, ye, po, _) = calls[i:i + 3]
        assert g == u == h == ffn, (calls[i:i + 3], ffn)
        assert ye == (*ffn[:2], cfg.d_model // dp), (ye, ffn)
        # mesh dims (data, model): partial over data, E over model
        assert pg == pu == (Partial(), Shard(0)), (pg, pu)
        assert po == (Shard(2), Shard(0)), po
    assert not any(partial for *_, partial in calls), calls
