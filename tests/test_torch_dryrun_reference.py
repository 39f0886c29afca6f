"""The dry run's per-card matrix FLOPs against the reference's own lowering.

For reduced configs (``get_config(arch).reduced()``, one prefill chunk, the
MoE at capacity factor 0.5 so that pairs drop) at S 32 x B 8, on
``("data", "model")`` meshes of one to four cards, the port's
``launch.dryrun.lower_cell`` on a fake mesh must count exactly the matrix
FLOPs of the reference's partitioned module, cell by cell: the sum over its
``dot`` instructions of 2 |out| prod(lhs contracting dims), with operand
shapes looked up by instruction name.  The reference lowers each cell with
``unroll_stacks=True`` under ``single_chunk()`` (so its module has no
``while`` loop, whose body XLA's counts would see once) on the first n of
``repro.launch.dryrun``'s placeholder devices, in one JAX subprocess for
the whole module (the pytest process keeps one device); the port's cells
trace here while it runs.  The cells: dense train cells (smollm, internlm2)
and the MoE's train, prefill and decode (deepseek-v3, dbrx) on 1x1, 2x2,
4x1 and 1x4 -- where XLA splits the experts' products over ``data`` (K
partials in a decode, the weight gathered in the forward only in a train
step), the router's over ``model``, and drops the recompute of a layer's
last product.  The reference's reduced smollm prefill and decode raise
``DuplicateSpecError`` there, so they are not held.  On a mismatch, and
under ``-s``, both sides' matrix products are printed side by side.
No card is needed.
"""
import collections
import dataclasses
import json
import os
import subprocess
import sys
import traceback
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch import analysis as A
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_fake_mesh, release_mesh

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
SEQ, BATCH = 32, 8
CELLS = [("smollm-135m", "train", (2, 2)), ("smollm-135m", "train", (4, 1)),
         ("internlm2-1.8b", "train", (2, 2))] + [
    ("deepseek-v3-671b", "train", m)
    for m in ((1, 1), (2, 2), (4, 1), (1, 4))] + [
    ("deepseek-v3-671b", "prefill", (2, 2))] + [
    ("deepseek-v3-671b", "decode", m)
    for m in ((1, 1), (2, 2), (4, 1), (1, 4))] + [
    ("dbrx-132b", "train", m) for m in ((1, 1), (2, 2), (1, 4))]

_REFERENCE = r'''
import dataclasses, json, re, sys
import numpy as np
from repro.launch import dryrun as RD      # sets the placeholder devices
import jax
from jax.sharding import Mesh
from repro.configs import ShapeConfig, get_config
from repro.models.analysis_flags import single_chunk

compiled = []
_terms = RD.cost_analysis_terms


def cost_analysis_terms(c):
    compiled.append(c)
    return _terms(c)


RD.cost_analysis_terms = cost_analysis_terms
DEF = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(\w+\[[\d,]*\])")
DOT = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(\w+\[[\d,]*\])\S*"
                 r"\s+dot\(([^)]*)\)(.*)$")


def dims(shape):
    return [int(n) for n in shape[shape.index("[") + 1:-1].split(",") if n]


def dots(text):
    shapes = {m.group(1): m.group(2) for m in map(DEF.match,
                                                  text.splitlines()) if m}
    out = []
    for line in text.splitlines():
        m = DOT.match(line)
        if not m:
            continue
        name, shape, operands, rest = m.groups()
        lhs, rhs = [shapes[o.strip().split()[-1].lstrip("%")]
                    for o in operands.split(",")]
        lc = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", rest)
        k = int(np.prod([dims(lhs)[int(i)]
                         for i in lc.group(1).split(",") if i])) if lc else 1
        op = re.search(r'op_name="([^"]*)"', rest)
        out.append({"name": name, "lhs": lhs, "rhs": rhs, "out": shape,
                    "k": k, "flops": 2 * int(np.prod(dims(shape))) * k,
                    "op_name": op.group(1) if op else ""})
    return out


devices = np.array(jax.devices())
seq, batch = int(sys.argv[3]), int(sys.argv[4])
results = []
for arch, kind, mesh_shape in json.loads(sys.argv[1]):
    cfg = get_config(arch).reduced().replace(unroll_stacks=True,
                                             prefill_chunks=1)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=0.5))
    n = int(np.prod(mesh_shape))
    mesh = Mesh(devices[:n].reshape(mesh_shape), ("data", "model"))
    with single_chunk():
        r = RD.lower_cell(cfg, ShapeConfig("c", seq, batch, kind), mesh)
    text = compiled.pop().as_text()
    ds = dots(text)
    results.append({"cell": [arch, kind, list(mesh_shape)],
                    "has_while": " while(" in text,
                    "dot_flops": sum(d["flops"] for d in ds), "dots": ds,
                    "collective_bytes": r["collective_bytes"],
                    "memory": r["memory"]})
with open(sys.argv[2], "w") as f:
    json.dump(results, f)
'''


class _Reference:
    """The reference's cells, lowered in a subprocess started at once and
    read on first use."""

    def __init__(self, root):
        self.path = root / "reference.json"
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(SRC))
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, json.dumps(CELLS),
             str(self.path), str(SEQ), str(BATCH)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        self._cells = None

    def cell(self, key):
        if self._cells is None:
            _, err = self.proc.communicate(timeout=600)
            assert self.proc.returncode == 0, err[-4000:]
            self._cells = {(a, k, tuple(m)): r for r in json.loads(
                self.path.read_text()) for a, k, m in [r["cell"]]}
        return self._cells[key]

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.communicate()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    ref = _Reference(tmp_path_factory.mktemp("dryrun_reference"))
    yield ref
    ref.close()


def _where():
    """The port's innermost two model functions on the stack ("backward"
    where autograd's engine runs the op)."""
    frames = [f for f in traceback.extract_stack()
              if "repro_torch" in f.filename and "launch" not in f.filename]
    return "/".join(f"{Path(f.filename).stem}.{f.name}"
                    for f in frames[-2:]) or "backward"


def port_cell(arch, kind, mesh_shape, monkeypatch):
    """The port's ``lower_cell`` of the cell, and its matrix products:
    (FLOPs, K, op, operand shapes, where)."""
    products = []

    class Recorded(A.OpCounter):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before = self.flops
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is not NotImplemented and self.flops != before:
                shapes = [tuple(t.shape) for t in args
                          if isinstance(t, torch.Tensor)]
                name = func._overloadpacket.__name__
                lhs = shapes[1] if name in ("addmm", "baddbmm") else shapes[0]
                products.append((self.flops - before, lhs[-1],
                                 name, shapes, _where()))
            return out

    monkeypatch.setattr(D, "OpCounter", Recorded)
    cfg = get_config(arch).reduced().replace(prefill_chunks=1)
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  capacity_factor=0.5))
    mesh = make_fake_mesh(mesh_shape, ("data", "model"))
    try:
        r = D.lower_cell(cfg, ShapeConfig("c", SEQ, BATCH, kind), mesh)
    finally:
        release_mesh()
    return r, products


def side_by_side(ref, products) -> str:
    """Both sides' matrix products by (FLOPs, K), the unmatched marked."""
    rk = collections.Counter((d["flops"], d["k"]) for d in ref["dots"])
    pk = collections.Counter(p[:2] for p in products)
    lines = [f"{'FLOPs':>10} {'K':>5}  {'reference dot (op_name)':<72}"
             f"port product (where)"]
    for key in sorted(set(rk) | set(pk), reverse=True):
        rs = [d for d in ref["dots"] if (d["flops"], d["k"]) == key]
        ps = [p for p in products if p[:2] == key]
        mark = "" if rk[key] == pk[key] else "  <-- differs"
        for i in range(max(len(rs), len(ps))):
            left = (f"{rs[i]['lhs']} x {rs[i]['rhs']} "
                    f"{rs[i]['op_name'][-40:]}" if i < len(rs) else "")
            right = " ".join(map(str, ps[i][2:])) if i < len(ps) else ""
            lines.append(f"{key[0]:>10} {key[1]:>5}  {left:<72}{right}"
                         + (mark if i == 0 else ""))
    return "\n".join(lines)


@pytest.mark.parametrize("arch,kind,mesh_shape", CELLS,
                         ids=[f"{a}-{k}-{m[0]}x{m[1]}" for a, k, m in CELLS])
def test_port_flops_equal_reference(reference, monkeypatch, request, arch,
                                    kind, mesh_shape):
    r, products = port_cell(arch, kind, mesh_shape, monkeypatch)
    ref = reference.cell((arch, kind, mesh_shape))
    assert not ref["has_while"]
    port = int(r["cost"]["hlo_flops"])
    assert sum(p[0] for p in products) == port
    if port != ref["dot_flops"] or \
            request.config.getoption("capture") == "no":
        print(f"\n{arch} {kind} {mesh_shape}: reference "
              f"{ref['dot_flops']}, port {port}; collectives reference "
              f"{ref['collective_bytes']}, port {r['collective_bytes']}")
        print(side_by_side(ref, products))
    assert port == ref["dot_flops"], (port, ref["dot_flops"])
