"""The paper scene's per-tile counts from the JAX reference, and the port
held to them.

Run as a script, this file writes ``src/repro_torch/data/reference_counts.json``
from the reference on the CPU, jitted, in chunks of tiles (counts add across
tiles, so chunking changes nothing):

    PYTHONPATH=src python tests/test_torch_reference_counts.py --write

- the paper scene ``synthetic_scene(7681, 7831, seed=0)`` at ``DifetConfig()``
  (256 tiles of 560^2), all seven algorithms, ``use_pallas=False``;
- SIFT on the same scene at ``DifetConfig(tile=256, halo=24,
  max_keypoints_per_tile=256)`` (961 tiles of 304^2), with
  ``use_pallas=True`` (Pallas in interpret mode) and with ``use_pallas=False``.

Each is run twice, each time in a process of its own: as XLA compiles it
for this CPU ("fma"), and with ``XLA_FLAGS=--xla_cpu_max_isa=AVX``
("no_fma").  XLA on the CPU contracts a multiply and the add after it into
one fused multiply-add where the CPU has one (``repro/core/pyramid.py::
blur_separable`` says so), so a blur's last bits, and now and then a SIFT
count, depend on the CPU; an instruction set without FMA leaves every
operation rounded once, in the reference's op order, as the port computes
it.  The port's counts are the "no_fma" ones.

``chip_smoke.py`` holds both routes of the port to every per-tile count of
the file on the card.  As tests, on the CPU, the port's plain route on three
tiles of the paper scene (the first, an interior one and the last) must give
the file's per-tile counts for all seven algorithms.
"""
import argparse
import functools
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.data import digests

ROOT = Path(__file__).resolve().parents[1]
COUNTS = ROOT / "src" / "repro_torch" / "data" / "reference_counts.json"
TILE256 = dict(tile=256, halo=24, max_keypoints_per_tile=256)
CHUNK512, CHUNK256 = 8, 31           # 256 = 32 x 8 tiles, 961 = 31 x 31
SAMPLED = (0, 137, 255)              # first, interior, last tile of 256
# the port's counts of the paper scene on the card (PERF.md)
TABLE2 = {"harris": 1020775, "shi_tomasi": 2535584, "sift": 64181,
          "surf": 842, "fast": 214858, "brief": 214858, "orb": 214858}

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def reference_per_tile(bundle, algorithms, cfg, use_pallas, chunk):
    """{algorithm: entry} from the reference's map (``extract_tile_multi``
    vmapped, ``chunk`` tiles a jitted call) and its reduce
    (``_reduce_features``) over all the tiles' outputs: the per-tile
    counts, each tile's digests of the exact fields and the reduce's."""
    import jax
    from repro.core import engine as jengine

    @jax.jit
    def per_tile(tiles, headers):
        return jax.vmap(functools.partial(
            jengine.extract_tile_multi, algorithms, cfg,
            use_pallas=use_pallas))(tiles, headers)

    n = len(bundle.tiles)
    assert n % chunk == 0, (n, chunk)
    parts = {alg: [] for alg in algorithms}
    for i in range(0, n, chunk):
        got = per_tile(bundle.tiles[i:i + chunk], bundle.headers[i:i + chunk])
        for alg in algorithms:
            parts[alg].append({k: np.asarray(v) for k, v in got[alg].items()})
    reduce = jax.jit(jengine._reduce_features)
    out = {}
    for alg in algorithms:
        whole = {k: np.concatenate([p[k] for p in parts[alg]])
                 for k in parts[alg][0]}
        top = {k: np.asarray(v) for k, v in reduce(whole).items()}
        out[alg] = entry([int(c) for c in whole["count"]],
                         digests.tile_digests(whole, alg),
                         digests.top_digests(top, alg))
    return out


def entry(per_tile, tile_digests, top):
    return {"total": sum(per_tile), "per_tile": per_tile,
            "digests": tile_digests, "top": top}


# XLA_FLAGS of each mode: none, and an instruction set without FMA
MODES = {"fma": "", "no_fma": "--xla_cpu_max_isa=AVX"}


def run_mode():
    """This process's counts: {"tile512": {alg: entry}, "tile256":
    {"use_pallas=...": entry}} (XLA_FLAGS as the process was given)."""
    from repro.configs.difet_paper import DifetConfig, PAPER_ALGORITHMS
    from repro.core.bundle import tile_scene
    from repro.data.landsat import synthetic_scene

    cfg, cfg256 = DifetConfig(), DifetConfig(**TILE256)
    scene = synthetic_scene(*cfg.scene_hw, seed=0)
    b512, b256 = tile_scene(scene, cfg), tile_scene(scene, cfg256)
    assert len(b512.tiles) == 256 and len(b256.tiles) == 961
    t0 = time.perf_counter()
    per = reference_per_tile(b512, PAPER_ALGORITHMS, cfg, False, CHUNK512)
    out = {"tile512": per, "tile256": {}}
    print(f"tile 512, seven algorithms: {time.perf_counter() - t0:.1f} s",
          {a: e["total"] for a, e in per.items()}, file=sys.stderr,
          flush=True)
    for use_pallas in (True, False):
        t0 = time.perf_counter()
        e = reference_per_tile(b256, ("sift",), cfg256, use_pallas,
                               CHUNK256)["sift"]
        out["tile256"][f"use_pallas={use_pallas}"] = e
        print(f"tile 256, sift, use_pallas={use_pallas}: "
              f"{time.perf_counter() - t0:.1f} s, total {e['total']}",
              file=sys.stderr, flush=True)
    return out


def dump(doc):
    """JSON with each list of counts or digests on one line."""
    return re.sub(r'\[\s+([\w",\s]+?)\s+\]',
                  lambda m: "[" + " ".join(m.group(1).split()) + "]",
                  json.dumps(doc, indent=1)) + "\n"


def fma_differs(doc):
    """{key: {field: [tiles]}}: where the FMA run's per-tile digests
    differ from the run without FMA, and the count fields where its
    totals do ("per_tile")."""
    out = {}
    for part in ("tile512", "tile256"):
        for name, e in doc[part]["no_fma"].items():
            f = doc[part]["fma"][name]
            moved = {"per_tile": [i for i, (a, b) in enumerate(zip(
                e["per_tile"], f["per_tile"])) if a != b]}
            for field, tiles in e["digests"].items():
                moved[field] = [i for i, (a, b) in enumerate(zip(
                    tiles, f["digests"][field])) if a != b]
            moved["top"] = [k for k in e["top"] if e["top"][k] != f["top"][k]]
            out[f"{part}/{name}"] = {k: v for k, v in moved.items() if v}
    return out


def write():
    doc = {"scene": {"generator": "synthetic_scene", "hw": [7681, 7831],
                     "seed": 0},
           "written_by": "tests/test_torch_reference_counts.py --write",
           "xla_flags": MODES,
           "tile512": {"config": "DifetConfig()", "use_pallas": False,
                       "tiles": 256},
           "tile256": {"config": f"DifetConfig(**{TILE256})", "tiles": 961,
                       "algorithm": "sift"}}
    for mode, flags in MODES.items():
        print(f"mode {mode} (XLA_FLAGS={flags!r}):", flush=True)
        env = dict(os.environ, XLA_FLAGS=" ".join(
            f for f in (os.environ.get("XLA_FLAGS", ""), flags) if f))
        done = subprocess.run([sys.executable, __file__, "--mode"],
                              env=env, stdout=subprocess.PIPE, text=True,
                              check=True)
        part = json.loads(done.stdout.splitlines()[-1])
        for key in ("tile512", "tile256"):
            doc[key][mode] = part[key]
    doc["fma_differs"] = fma_differs(doc)
    COUNTS.write_text(dump(doc))
    print(f"wrote {COUNTS.relative_to(ROOT)}")


# --- tests ----------------------------------------------------------------
@pytest.fixture(scope="module")
def reference():
    return json.loads(COUNTS.read_text())


@pytest.fixture(scope="module")
def paper_scene():
    from repro_torch.configs.difet_paper import DifetConfig
    from repro_torch.core.bundle import tile_scene
    from repro_torch.data.landsat import synthetic_scene
    cfg = DifetConfig()
    b = tile_scene(synthetic_scene(*cfg.scene_hw, seed=0), cfg)
    assert len(b.tiles) == 256
    return cfg, b


def port_map(paper_scene, algorithms, idx):
    """The port's plain route on tiles ``idx`` of the paper scene: its
    map's output, {algorithm: features [len(idx), ...]}."""
    from repro_torch.core import engine
    cfg, b = paper_scene
    return engine.extract_tile_multi(
        algorithms, cfg, torch.as_tensor(b.tiles[list(idx)]),
        torch.as_tensor(b.headers[list(idx)], dtype=torch.int32),
        use_kernels=False)


@pytest.fixture(scope="module")
def sampled_port(paper_scene):
    from repro_torch.configs.difet_paper import PAPER_ALGORITHMS
    return port_map(paper_scene, PAPER_ALGORITHMS, SAMPLED)


@pytest.fixture(scope="module")
def sampled_port_counts(sampled_port):
    return {alg: r["count"].tolist() for alg, r in sampled_port.items()}


ALGORITHMS = ("harris", "shi_tomasi", "sift", "surf", "fast", "brief", "orb")


@pytest.mark.parametrize("alg", ALGORITHMS)
def test_sampled_tiles_equal_the_reference(reference, sampled_port_counts,
                                           alg):
    for mode in ("no_fma", "fma"):
        want = reference["tile512"][mode][alg]["per_tile"]
        assert sampled_port_counts[alg] == [want[i] for i in SAMPLED], mode


@pytest.mark.parametrize("alg", ALGORITHMS)
def test_sampled_tiles_match_the_reference_digests(reference, sampled_port,
                                                   alg):
    """Keypoints, valid flags and packed descriptor words of the sampled
    tiles, field by field, those of the reference's run without FMA."""
    want = reference["tile512"]["no_fma"][alg]["digests"]
    got = digests.tile_digests(sampled_port[alg], alg)
    assert set(got) == set(want) == set(digests.fields(alg))
    for field in got:
        assert got[field] == [want[field][i] for i in SAMPLED], field


# tiles whose ORB words moved with torch's own atan2, sin, cos and moment
# sums: keypoints whose angle sits on a bin edge (+-pi/2, a moment near 0)
ORB_EDGE_TILES = (31, 47)


def test_orb_words_at_bin_edges_equal_the_reference(reference, paper_scene):
    """ORB's words where the angle sits on a bin edge: the moments summed
    in XLA's order, fdlibm's atan2f, cos and sin rounded once."""
    got = digests.tile_digests(
        port_map(paper_scene, ("orb",), ORB_EDGE_TILES)["orb"], "orb")
    want = reference["tile512"]["no_fma"]["orb"]["digests"]
    for field in got:
        assert got[field] == [want[field][i] for i in ORB_EDGE_TILES], field


def test_digests_of_the_exact_fields():
    """A field's digest depends on its values, not on the dtype it is held
    in: the port's int64 rows and int32 words hash as the reference's int32
    rows and uint32 words."""
    rng = np.random.RandomState(0)
    ys = rng.randint(-40, 8000, (3, 512))
    words = rng.randint(0, 2**32, (3, 512, 8), dtype=np.uint64).astype(
        np.uint32)
    valid = rng.rand(3, 512) < 0.5
    for field, a, b in (("ys", ys.astype(np.int64), ys.astype(np.int32)),
                        ("desc", words.view(np.int32), words),
                        ("valid", torch.from_numpy(valid), valid)):
        assert digests.digest(a, field) == digests.digest(b, field)
    assert digests.digest(ys, "ys") != digests.digest(ys + 1, "ys")
    per = digests.tile_digests({"ys": ys, "xs": ys, "valid": valid,
                                "desc": words}, "orb")
    assert set(per) == {"ys", "xs", "valid", "desc"}
    assert len(per["desc"]) == 3 and len(set(per["desc"])) == 3
    assert digests.fields("sift") == ("ys", "xs", "valid")


def test_reference_digests_cover_every_tile(reference):
    """Both runs keep a digest of each exact field for every tile and of
    the reduce, at tile 512 and tile 256 (both reference routes)."""
    for mode in ("no_fma", "fma"):
        for part, n in (("tile512", 256), ("tile256", 961)):
            for name, e in reference[part][mode].items():
                alg = "sift" if part == "tile256" else name
                assert set(e["digests"]) == set(e["top"]) \
                    == set(digests.fields(alg)), (part, name)
                for tiles in e["digests"].values():
                    assert len(tiles) == n
    assert set(reference["fma_differs"]) == \
        {f"tile512/{a}" for a in ALGORITHMS} | \
        {"tile256/use_pallas=True", "tile256/use_pallas=False"}


def test_reference_totals(reference):
    """Without FMA contraction the reference counts what the port counts on
    the card (Table 2); with it, SIFT moves by a keypoint at a few tiles."""
    for mode in ("no_fma", "fma"):
        algs = reference["tile512"][mode]
        assert set(algs) == set(ALGORITHMS)
        for e in algs.values():
            assert len(e["per_tile"]) == 256
            assert sum(e["per_tile"]) == e["total"]
    exact, fma = reference["tile512"]["no_fma"], reference["tile512"]["fma"]
    assert {a: e["total"] for a, e in exact.items()} == TABLE2
    assert all(fma[a]["per_tile"] == exact[a]["per_tile"]
               for a in ALGORITHMS if a != "sift")


def test_reference_tile256_sift_routes(reference):
    for mode in ("no_fma", "fma"):
        sift = reference["tile256"][mode]
        assert set(sift) == {"use_pallas=True", "use_pallas=False"}
        for e in sift.values():
            assert len(e["per_tile"]) == 961
            assert sum(e["per_tile"]) == e["total"] > 0


_BLUR = """
import jax, numpy as np, torch
from repro.core import pyramid as jpyramid
from repro.data.landsat import synthetic_scene
from repro_torch.core.pyramid import blur_separable
x = synthetic_scene(96, 96, seed=0)
jitted = np.asarray(jax.jit(lambda a: jpyramid.blur_separable(a, 1.6))(x))
eager = np.asarray(jpyramid.blur_separable(x, 1.6))
port = blur_separable(torch.from_numpy(x), 1.6).numpy()
print(int((port != jitted).sum()), int((port != eager).sum()),
      float(np.abs(port - jitted).max()))
"""


@pytest.mark.parametrize("mode", sorted(MODES))
def test_reference_blur_against_the_port(mode):
    """Why the file keeps two runs of the reference: the port's blur is the
    reference's op by op, bit for bit; jitted without FMA the reference
    gives the same bits, and with FMA contraction (where the CPU has it)
    values within an ulp or so."""
    env = dict(os.environ, XLA_FLAGS=MODES[mode], JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _BLUR], env=env,
                         stdout=subprocess.PIPE, text=True, check=True)
    vs_jitted, vs_eager, err = out.stdout.split()
    assert int(vs_eager) == 0
    if mode == "no_fma":
        assert int(vs_jitted) == 0
    assert float(err) <= 1e-6


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--write", action="store_true",
                   help="run the reference in both modes and write the file")
    p.add_argument("--mode", action="store_true",
                   help="(internal) print this process's counts as JSON")
    args = p.parse_args()
    if args.mode:
        print(json.dumps(run_mode()))
    elif args.write:
        write()
    else:
        p.print_help()
        sys.exit(2)
