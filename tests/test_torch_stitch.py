"""The port's stitching workload (``repro_torch.launch.stitch``, with
``core/{job,mosaic,matching}``) against the JAX package's, end to end on
the CPU: the reference's own arguments (3 scenes of 256^2, tile 64,
brief), checkpointed resume, a killed match phase, and the layout solve.
"""
import os

import numpy as np
import pytest
import torch

from repro.core import mosaic as jmosaic
from repro.launch import stitch as jstitch
from repro_torch.core import bundle, mosaic
from repro_torch.core.job import DifetJob, LeaseBoard
from repro_torch.launch import stitch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

ARGS = ["--scenes", "3", "--scene-size", "256", "--overlap", "128",
        "--tile", "64", "--algorithm", "brief", "--min-inliers", "8"]


def test_stitch_matches_reference_and_resumes(tmp_path):
    """Same placed scenes and positions within 1e-3 px as the reference,
    every scene within 1 px of the truth; a second call resumes from the
    store and reproduces the layout exactly."""
    want = jstitch.main(ARGS + ["--store", str(tmp_path / "ref")])
    args = ARGS + ["--store", str(tmp_path / "port")]
    got = stitch.main(args, device="cpu")
    assert got["max_err"] is not None and got["max_err"] <= 1.0
    assert not got["dropped"]
    assert set(got["positions"]) == set(want["positions"]) and \
        len(got["positions"]) == 3
    for name, pos in got["positions"].items():
        np.testing.assert_allclose(pos, want["positions"][name], atol=1e-3)
    for pair, t in got["pairs"].items():
        np.testing.assert_allclose(t, want["pairs"][pair], atol=1e-3)
    again = stitch.main(args, device="cpu")
    assert again["positions"] == got["positions"]
    assert again["pairs"] == got["pairs"]


def test_stitch_plain_route_equals_kernel_route(tmp_path):
    """``--no-use-kernels`` (torch paths) and the default (the kernels'
    wrappers, their twins on the CPU) give the same layout."""
    plain = stitch.main(ARGS + ["--store", str(tmp_path / "a"),
                                "--no-use-kernels", "--device", "cpu"])
    kern = stitch.main(ARGS + ["--store", str(tmp_path / "b"),
                               "--device", "cpu"])
    assert plain["positions"] == kern["positions"]
    assert plain["pairs"] == kern["pairs"]


def test_stitch_match_phase_restart_after_failure(tmp_path):
    """Kill the match phase after its first chunk; the same command resumes
    and finishes."""
    args = ARGS + ["--store", str(tmp_path / "s"), "--pairs-per-step", "1",
                   "--device", "cpu"]
    with pytest.raises(SystemExit):
        stitch.main(args + ["--fail-after", "1"])
    out = stitch.main(args)
    assert out["max_err"] is not None and out["max_err"] <= 1.0
    assert len(out["positions"]) == 3


def test_stitch_refuses_a_store_the_reference_built(tmp_path):
    """A store is named, never defaulted, and one that the JAX package
    built is refused: its stored features are not taken as the port's."""
    from repro.configs.difet_paper import DifetConfig as JaxConfig
    with pytest.raises(SystemExit):
        stitch.main(ARGS + ["--device", "cpu"])       # no --store
    jstitch.build_overlapping_store(
        tmp_path / "ref", 3, 256, 128,
        JaxConfig(tile=64, halo=24, max_keypoints_per_tile=256,
                  fast_threshold=0.08))
    with pytest.raises(SystemExit, match="was built with"):
        stitch.main(ARGS + ["--store", str(tmp_path / "ref"),
                            "--device", "cpu"])


def test_solve_layout_drops_unverified_pairs():
    names = ["a", "b", "c"]
    results = {
        ("a", "b"): {"t": np.array([0.0, -10.0]), "n_inliers": 50},
        ("b", "c"): {"t": np.array([2.0, -20.0]), "n_inliers": 3},  # weak
    }
    pos, dropped = mosaic.solve_layout(names, results, min_inliers=8)
    jpos, jdropped = jmosaic.solve_layout(names, results, min_inliers=8)
    assert dropped == jdropped == [("b", "c")]
    assert set(pos) == set(jpos) == {"a", "b"}
    np.testing.assert_allclose(pos["b"], [0.0, 10.0])
    summary = mosaic.mosaic_summary(pos, (100, 100))
    assert summary == jmosaic.mosaic_summary(jpos, (100, 100))
    assert summary["n_scenes"] == 2 and summary["mosaic_hw"] == (100, 110)


def test_solve_layout_chain_propagation():
    names = [f"s{i}" for i in range(4)]
    results = {(names[i], names[i + 1]):
               {"t": np.array([float(i), -64.0]), "n_inliers": 20}
               for i in range(3)}
    pos, dropped = mosaic.solve_layout(names, results)
    jpos, _ = jmosaic.solve_layout(names, results)
    assert not dropped and len(pos) == 4
    np.testing.assert_allclose(pos["s3"], [-(0 + 1 + 2), 3 * 64.0])
    for n in names:
        np.testing.assert_array_equal(pos[n], jpos[n])


def test_extraction_job_restarts_deterministically(tmp_path):
    """DifetJob killed after one bundle resumes and stores the same results
    as an uninterrupted run."""
    from repro_torch.configs.difet_paper import DifetConfig
    from repro_torch.data.landsat import synthetic_scene
    cfg = DifetConfig(tile=64, halo=24, max_keypoints_per_tile=32)
    results = []
    for name, fail in (("once", None), ("killed", 1)):
        store = bundle.BundleStore(tmp_path / name)
        for i in range(2):
            store.put(f"b{i}", bundle.bundle_scenes(
                [synthetic_scene(96, 96, seed=i)], cfg))
        job = DifetJob(store, "fast,orb", device="cpu")
        if fail:
            with pytest.raises(RuntimeError):
                job.run(simulate_failure_after=fail)
            job = DifetJob(store, "fast,orb", device="cpu")
            assert job.manifest.remaining == ["b1"]
        summary = job.run()
        assert summary["bundles_done"] == 2
        results.append({f"{b}.{a}": store.get_result(f"{b}.{a}")
                        for b in ("b0", "b1") for a in ("fast", "orb")})
    for key, r in results[0].items():
        for k, v in r.items():
            np.testing.assert_array_equal(v, results[1][key][k])


def test_lease_board_claims_refreshes_and_steals(tmp_path):
    board = LeaseBoard(tmp_path / "leases", ttl_s=60.0)
    assert board.acquire("item", "w0")
    assert not board.acquire("item", "w1")          # live lease elsewhere
    assert board.acquire("item", "w0")              # refresh own
    assert board.holder("item")[0] == "w0" and board.fresh("item")
    board.release("item", "w1")                     # not the holder: no-op
    assert board.holder("item")[0] == "w0"
    board.release("item", "w0")
    assert board.holder("item") is None
    stale = LeaseBoard(tmp_path / "stale", ttl_s=0.0)
    assert stale.acquire("item", "w0")
    assert stale.acquire("item", "w1")              # expired: stolen
    assert stale.holder("item")[0] == "w1"
