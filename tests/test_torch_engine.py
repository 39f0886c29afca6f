"""The port's map/reduce (``repro_torch.core.engine``) against the JAX
package's, end to end on the CPU: all seven algorithms on a 128x128 scene
cut into 16 tiles (tile 32, halo 24, K 32), in both kernel modes.

Counts, keypoint coordinates, valid flags and packed descriptor bits are
exact; scores within rtol 1e-5 / atol 1e-7 and float descriptors within
atol 1e-5.  The JAX side is jitted (its unjitted per-op dispatch is what
makes it slow on the CPU).
"""
import ast
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.difet_paper import DifetConfig as JaxConfig
from repro.core import bundle as jbundle
from repro.core import engine as jengine
from repro.data.landsat import synthetic_scene
from repro_torch.configs.difet_paper import DifetConfig, PAPER_ALGORITHMS
from repro_torch.core import bundle, engine

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

SMALL = dict(tile=32, halo=24, max_keypoints_per_tile=32)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def small_bundle():
    scene = synthetic_scene(128, 128, seed=3)
    return jbundle.tile_scene(scene, JaxConfig(**SMALL))


@functools.lru_cache(maxsize=None)
def _jax_multi(use_pallas):
    return jax.jit(functools.partial(
        jengine.extract_features_multi, algorithms=PAPER_ALGORITHMS,
        cfg=JaxConfig(**SMALL), use_pallas=use_pallas))


def assert_result_matches(got, want):
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    assert set(got) == set(want)
    for key in ("total_count", "per_tile_count", "keypoint_count", "top_ys",
                "top_xs", "top_valid"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["top_scores"], want["top_scores"],
                               rtol=1e-5, atol=1e-7)
    if "top_desc" in want:
        if want["top_desc"].dtype == np.uint32:
            np.testing.assert_array_equal(got["top_desc"],
                                          want["top_desc"].view(np.int32))
        else:
            np.testing.assert_allclose(got["top_desc"], want["top_desc"],
                                       rtol=0, atol=1e-5)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_all_algorithms_match_reference(small_bundle, use_kernels):
    """use_kernels=True against the reference's use_pallas=True (at tile 32
    every SIFT octave is fused, pad once), and False against False."""
    want = _jax_multi(use_kernels)(small_bundle.tiles, small_bundle.headers)
    got = engine.extract_features_multi(
        small_bundle.tiles, small_bundle.headers, PAPER_ALGORITHMS,
        DifetConfig(**SMALL), use_kernels=use_kernels, device="cpu")
    for alg in PAPER_ALGORITHMS:
        assert_result_matches(got[alg], want[alg])
        assert int(got[alg]["total_count"]) > 0, alg


def test_table2_quick_counts_equal_the_reference_snapshot():
    """The reference's quick Table-2 counts (BENCH_ad3cad5.json: three
    256x256 scenes, tile 128, K 128, benchmarks/table2_counts.py, which
    runs the reference's plain route)."""
    cfg = DifetConfig(tile=128, halo=24, max_keypoints_per_tile=128)
    b = bundle.bundle_scenes([synthetic_scene(256, 256, seed=i)
                              for i in range(3)], cfg)
    res = engine.extract_features_multi(b.tiles, b.headers, PAPER_ALGORITHMS,
                                        cfg, use_kernels=False, device="cpu")
    counts = {alg: int(res[alg]["total_count"]) for alg in PAPER_ALGORITHMS}
    assert counts == {"harris": 978, "shi_tomasi": 2860, "sift": 54,
                      "surf": 17, "fast": 295, "brief": 295, "orb": 295}


def test_entry_points_default_to_the_kernel_route(small_bundle):
    """With no ``use_kernels`` argument the entry point takes the kernel
    route (on a CPU tensor, the kernels' plain twins)."""
    cfg = DifetConfig(**SMALL)
    default = engine.extract_features_multi(
        small_bundle.tiles, small_bundle.headers, PAPER_ALGORITHMS, cfg,
        device="cpu")
    kernels = engine.extract_features_multi(
        small_bundle.tiles, small_bundle.headers, PAPER_ALGORITHMS, cfg,
        use_kernels=True, device="cpu")
    for alg in PAPER_ALGORITHMS:
        for key, v in kernels[alg].items():
            assert torch.equal(v, default[alg][key]), (alg, key)


@pytest.mark.parametrize("alg", ["harris", "orb"])
def test_single_algorithm_matches_multi(small_bundle, alg):
    cfg = DifetConfig(**SMALL)
    one = engine.extract_features(small_bundle.tiles, small_bundle.headers,
                                  alg, cfg, device="cpu")
    many = engine.extract_features_multi(small_bundle.tiles,
                                         small_bundle.headers,
                                         PAPER_ALGORITHMS, cfg, device="cpu")
    for key, v in one.items():
        assert torch.equal(v, many[alg][key]), key


def test_request_features_match_reference(small_bundle):
    tiles, headers = small_bundle.tiles[:3], small_bundle.headers[:3]
    algs = ("harris", "brief")
    want = jax.jit(functools.partial(
        jengine.extract_request_features, algorithms=algs,
        cfg=JaxConfig(**SMALL)))(tiles, headers)
    got = engine.extract_request_features(tiles, headers, algs,
                                          DifetConfig(**SMALL),
                                          use_kernels=False, device="cpu")
    for alg in algs:
        for i in range(3):
            assert_result_matches({k: v[i] for k, v in got[alg].items()},
                                  {k: v[i] for k, v in want[alg].items()})


def test_normalize_algorithms():
    assert engine.normalize_algorithms(" orb,fast ,orb") == ("orb", "fast")
    with pytest.raises(ValueError):
        engine.normalize_algorithms("harris,nope")
    with pytest.raises(ValueError):
        engine.normalize_algorithms(",")


def test_entry_point_without_cuda_raises(small_bundle):
    """With no CUDA and no explicit device="cpu" an entry point raises
    instead of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA, so the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine.extract_features_multi(small_bundle.tiles, small_bundle.headers,
                                      ("harris",), DifetConfig(**SMALL))


def test_port_imports_neither_jax_nor_the_reference():
    """Every module of repro_torch, and chip_smoke.py, load without pulling
    in jax or any module of the JAX package."""
    code = """
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, sys.argv[1])
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
assert len(names) >= 20, names
assert not bad, bad
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_port_sources_import_neither_jax_nor_the_reference():
    """The same rule read from the sources, so that imports inside
    functions (chip_smoke.py's, the kernel wrappers') are covered too."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, name)
