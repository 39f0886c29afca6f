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
    """{algorithm: [count of each tile]} from the reference's
    ``extract_features_multi``, ``chunk`` tiles a jitted call."""
    import jax
    from repro.core import engine as jengine

    @jax.jit
    def counts(tiles, headers):
        res = jengine.extract_features_multi(tiles, headers, algorithms, cfg,
                                             use_pallas=use_pallas)
        return {alg: res[alg]["per_tile_count"] for alg in algorithms}

    n = len(bundle.tiles)
    assert n % chunk == 0, (n, chunk)
    out = {alg: [] for alg in algorithms}
    for i in range(0, n, chunk):
        got = counts(bundle.tiles[i:i + chunk], bundle.headers[i:i + chunk])
        for alg in algorithms:
            out[alg] += [int(c) for c in np.asarray(got[alg])]
    return out


def entry(per_tile):
    return {"total": sum(per_tile), "per_tile": per_tile}


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
    out = {"tile512": {a: entry(per[a]) for a in per}, "tile256": {}}
    print(f"tile 512, seven algorithms: {time.perf_counter() - t0:.1f} s",
          {a: sum(c) for a, c in per.items()}, file=sys.stderr, flush=True)
    for use_pallas in (True, False):
        t0 = time.perf_counter()
        per = reference_per_tile(b256, ("sift",), cfg256, use_pallas,
                                 CHUNK256)["sift"]
        out["tile256"][f"use_pallas={use_pallas}"] = entry(per)
        print(f"tile 256, sift, use_pallas={use_pallas}: "
              f"{time.perf_counter() - t0:.1f} s, total {sum(per)}",
              file=sys.stderr, flush=True)
    return out


def dump(doc):
    """JSON with each list of counts on one line."""
    return re.sub(r"\[\s+([\d,\s]+?)\s+\]",
                  lambda m: "[" + " ".join(m.group(1).split()) + "]",
                  json.dumps(doc, indent=1)) + "\n"


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
    COUNTS.write_text(dump(doc))
    print(f"wrote {COUNTS.relative_to(ROOT)}")


# --- tests ----------------------------------------------------------------
@pytest.fixture(scope="module")
def reference():
    return json.loads(COUNTS.read_text())


@pytest.fixture(scope="module")
def sampled_port_counts():
    """The port's plain route on the SAMPLED tiles of the paper scene."""
    from repro_torch.configs.difet_paper import DifetConfig, PAPER_ALGORITHMS
    from repro_torch.core import engine
    from repro_torch.core.bundle import tile_scene
    from repro_torch.data.landsat import synthetic_scene
    cfg = DifetConfig()
    b = tile_scene(synthetic_scene(*cfg.scene_hw, seed=0), cfg)
    assert len(b.tiles) == 256
    idx = list(SAMPLED)
    res = engine.extract_features_multi(b.tiles[idx], b.headers[idx],
                                        PAPER_ALGORITHMS, cfg,
                                        use_kernels=False, device="cpu")
    return {alg: res[alg]["per_tile_count"].tolist()
            for alg in PAPER_ALGORITHMS}


ALGORITHMS = ("harris", "shi_tomasi", "sift", "surf", "fast", "brief", "orb")


@pytest.mark.parametrize("alg", ALGORITHMS)
def test_sampled_tiles_equal_the_reference(reference, sampled_port_counts,
                                           alg):
    for mode in ("no_fma", "fma"):
        want = reference["tile512"][mode][alg]["per_tile"]
        assert sampled_port_counts[alg] == [want[i] for i in SAMPLED], mode


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
    assert all(fma[a] == exact[a] for a in ALGORITHMS if a != "sift")


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
