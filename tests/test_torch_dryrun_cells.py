"""The dry run's routes to a cell's figures, against the direct count, and
the placement of decode's tokens.

``launch/dryrun.py::count_cell`` counts the cells whose direct trace is too
long from probes: train cells of many microbatches from two smaller
microbatch counts (the microbatch split counted alone), xLSTM's train and
prefill from two shorter sequences at smaller stacks, and a cell of
`DEPTH_CELLS` from the depth variants `launch/correction.py` traces. On
reduced configs on fake meshes, each route must give every figure the
direct trace gives: FLOPs, bytes, collectives by kind, argument, output,
temporary and peak bytes, state bytes and the peak's tensors (the depth
route all but the peak, whose place moves with the depth). The production
cells must take the routes ``PERF.md`` records. Decode's tokens must reach
``decode_step`` replicated on every mesh axis, as the reference's
``in_shardings`` of None place them (``src/repro/launch/dryrun.py:86-93``).
No card is needed.
"""
import contextlib
import os

import pytest
import torch
from torch.utils._pytree import tree_leaves

from repro_torch.configs import SHAPES, ShapeConfig, all_arch_ids, \
    applicable_shapes, get_config
from repro_torch.launch import analysis as A
from repro_torch.launch import dryrun as D
from repro_torch.launch.correction import stack_knobs
from repro_torch.launch.mesh import make_fake_mesh, release_mesh
from repro_torch.models import model as MM

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

FIGURES = ("cost", "collective_bytes", "collective_bytes_total", "memory",
           "state_bytes_per_device", "peak_tensors", "n_params",
           "n_active_params", "model_flops", "useful_flops_ratio",
           "roofline", "microbatches", "shape")


@contextlib.contextmanager
def fake_mesh(shape):
    mesh = make_fake_mesh(shape, ("data", "model"))
    try:
        yield mesh
    finally:
        release_mesh()


def assert_same(direct, routed, route, skip=()):
    assert direct["counted"] == "direct"
    assert routed["counted"]["route"] == route
    for key in FIGURES:
        if key not in skip:
            assert routed[key] == direct[key], (key, routed[key],
                                                direct[key])


@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v3-671b"])
def test_microbatch_route_equals_direct(arch):
    """4 microbatches from probes at 2 and 3: the split's all-gathers of
    the whole batch (one a microbatch) are counted alone, the rest is
    affine in the microbatch count."""
    cfg = get_config(arch).reduced()
    shape = ShapeConfig("t", 16, 16, "train")
    with fake_mesh((2, 2)) as mesh:
        direct = D.lower_cell(cfg, shape, mesh, microbatches=4)
        routed = D.count_cell(cfg, shape, mesh, microbatches=4,
                              route="microbatches")
    assert routed["counted"]["probes"] == [2, 3]
    assert routed["counted"]["split_at_n"]["collectives"]["all-gather"] > 0
    assert_same(direct, routed, "microbatches")


def test_sequence_route_equals_direct(monkeypatch):
    """xLSTM's prefill at S 1280 from S 512 and 768: the sLSTM's S steps,
    the mLSTM's chunks of 256 and the per-token ops, every figure affine
    in S.  The direct trace's bytes are those of the ops that return a
    tensor: each sLSTM step's ``.device`` query of the whole input, which
    returns none, counts no bytes."""
    queried, moved = [0], [0]

    class Queries(A.OpCounter):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is NotImplemented or func.is_view or \
                    func.namespace in A._COLLECTIVE_NS or \
                    getattr(A._propagating, "on", False):
                return out
            ts = [t for t in tree_leaves((args, kwargs, out))
                  if isinstance(t, torch.Tensor)]
            outs = [t for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor)]
            (moved if outs else queried)[0] += sum(
                t.numel() * t.element_size() for t in ts)
            return out

    cfg = get_config("xlstm-350m").reduced()
    shape = ShapeConfig("p", 1280, 4, "prefill")
    with fake_mesh((2, 2)) as mesh:
        monkeypatch.setattr(D, "OpCounter", Queries)
        direct = D.lower_cell(cfg, shape, mesh)
        monkeypatch.undo()
        routed = D.count_cell(cfg, shape, mesh, route="sequence")
    assert routed["counted"]["probes"] == list(D.SEQ_PROBES)
    assert queried[0] > 0
    assert direct["cost"]["hlo_bytes"] == moved[0]
    assert_same(direct, routed, "sequence")


def test_depth_route_equals_direct():
    """A 3-layer stack from its 1- and 2-layer variants: every figure but
    the peak."""
    cfg = stack_knobs(get_config("internlm2-1.8b").reduced())[2]((3,))
    shape = ShapeConfig("t", 16, 8, "train")
    with fake_mesh((2, 2)) as mesh:
        direct = D.lower_cell(cfg, shape, mesh, microbatches=2)
        routed = D.count_cell(cfg, shape, mesh, microbatches=2,
                              route="depth")
    assert routed["counted"]["probes"] == [(1,), (2,)]
    assert_same(direct, routed, "depth",
                skip=("memory", "peak_tensors"))
    for key in ("argument_bytes", "output_bytes"):
        assert routed["memory"][key] == direct["memory"][key]


def test_production_cells_take_their_routes():
    """On (16, 16): the five cells that do not trace in ten minutes, and
    the three train cells of 8 microbatches (probes at 2 and 3 cost 5/8 of
    the cell) take probes; every other cell is traced directly."""
    want = {("dbrx-132b", "train_4k"): ("microbatches", (2, 4)),
            ("deepseek-v3-671b", "train_4k"): ("microbatches", (2, 3)),
            ("glm4-9b", "train_4k"): ("microbatches", (2, 3)),
            ("internvl2-2b", "train_4k"): ("microbatches", (2, 3)),
            ("qwen1.5-110b", "train_4k"): ("microbatches", (2, 3)),
            ("xlstm-350m", "train_4k"): ("sequence", D.SEQ_PROBES),
            ("xlstm-350m", "prefill_32k"): ("sequence", D.SEQ_PROBES),
            ("zamba2-2.7b", "train_4k"): ("depth", [(1,), (2,)])}
    cells = [(a, s) for a in all_arch_ids()
             for s in applicable_shapes(get_config(a))]
    assert len(cells) == 32
    with fake_mesh((16, 16)) as mesh:
        for arch, s in cells:
            shape = SHAPES[s]
            mb = D.TRAIN_MICROBATCHES[arch] if shape.kind == "train" else 1
            got = D.route_of(get_config(arch), shape, mesh, mb)
            assert got == want.get((arch, s), ("direct", ())), (arch, s)


@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
def test_decode_tokens_replicated(monkeypatch, mesh_shape):
    """The decode cell's tokens reach ``decode_step`` replicated on every
    mesh axis and the position is a plain 0."""
    from torch.distributed.tensor import Replicate
    seen = []
    decode_step = MM.BaseLM.decode_step

    def recorded(self, cache, tokens, pos):
        seen.append((tuple(tokens.placements), tuple(tokens.shape), pos))
        return decode_step(self, cache, tokens, pos)

    monkeypatch.setattr(MM.BaseLM, "decode_step", recorded)
    cfg = get_config("internlm2-1.8b").reduced()
    with fake_mesh(mesh_shape) as mesh:
        r = D.lower_cell(cfg, ShapeConfig("d", 32, 4, "decode"), mesh)
    assert seen == [((Replicate(),) * 2, (4, 1), 0)]
    assert r["decode_inputs"] == {"tokens": ["R", "R"], "pos": 0}
