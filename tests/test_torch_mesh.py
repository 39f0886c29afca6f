"""The port's data mesh (``repro_torch.distributed``, and the mesh branches
of ``core/{engine,job,mosaic}.py``, ``data/pipeline.py`` and
``launch/scale.py``) against the JAX package's on 4 host devices.

The reference runs once for the module, in a subprocess whose XLA has 4
host devices and rounds once per operation (``--xla_cpu_max_isa=AVX``);
the port runs on a mesh of ``("cpu",) * 4``.  Exact fields (counts,
keypoints, valid flags, packed descriptor words) are equal; scores within
rtol 1e-5 / atol 1e-7, float descriptors within atol 1e-5, offsets within
1e-3 px (the reference's tolerances).  Every mesh result is also held bit
for bit to the port's own one-device run, and the two-stage reduce to the
one-stage reduce on random candidates.
"""
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.difet_paper import DifetConfig, PAPER_ALGORITHMS
from repro_torch.core import engine, mosaic
from repro_torch.core.bundle import BundleStore, TileBundle, tile_scene
from repro_torch.core.job import DifetJob
from repro_torch.data.landsat import synthetic_scene
from repro_torch.data.pipeline import Prefetcher
from repro_torch.distributed import (Mesh, MeshRunner, Sharded, data_mesh,
                                     dp_axes, one_device, shard, split_rows)
from repro_torch.kernels.build import CudaKernel
from repro_torch.launch import scale, stitch
from repro_torch.launch.mesh import make_host_mesh

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
CPU4 = Mesh(["cpu"] * 4)
CFG = DifetConfig(tile=32, halo=16, max_keypoints_per_tile=16)
DIST_ALGORITHMS = ("harris", "sift", "orb")
STITCH_CFG = dict(tile=64, halo=24, max_keypoints_per_tile=64,
                  fast_threshold=0.08)
STITCH_GEOM = (4, 160, 80)         # scenes, scene size, overlap: 3 pairs
SMOKE = dict(tile=64, halo=16, max_keypoints_per_tile=128)

_JAX_MESH = """
import sys
import jax
import numpy as np
from repro.configs.difet_paper import DifetConfig
from repro.core import engine, mosaic
from repro.core.bundle import BundleStore, TileBundle
from repro.core.job import DifetJob
from repro.distributed.sharding import data_mesh
from repro.launch import scale, stitch
from repro.launch.mesh import make_host_mesh

inp = np.load(sys.argv[1])
root = sys.argv[2]
out = {{"devices": np.asarray(len(jax.devices()))}}
mesh = data_mesh(4)
cfg = DifetConfig(**{cfg})
for alg in {dist_algorithms}:
    fn = engine.make_distributed_extractor(alg, cfg, mesh)
    for k, v in jax.device_get(fn(inp["tiles"][:8], inp["headers"][:8])).items():
        out[f"dist/{{alg}}/{{k}}"] = np.asarray(v)
store = BundleStore(root + "/job")
store.put("b0", TileBundle(inp["tiles"][:6], inp["headers"][:6], cfg))
DifetJob(store, {algorithms!r}, mesh=mesh).run()
for alg in {algorithms!r}.split(","):
    for k, v in store.get_result(f"b0.{{alg}}").items():
        out[f"job/{{alg}}/{{k}}"] = np.asarray(v)
n, size, overlap = {stitch_geom}
sstore, _ = stitch.build_overlapping_store(
    root + "/stitch", n, size, overlap, DifetConfig(**{stitch_cfg}))
scenes = sstore.list()
DifetJob(sstore, "brief", shards_per_bundle=1).run()
phase = mosaic.MatchPhase(sstore, list(zip(scenes, scenes[1:])), "brief",
                          mesh=make_host_mesh())
phase.run()
for (a, b), r in phase.results().items():
    for k, v in r.items():
        out[f"match/{{a}}__{{b}}/{{k}}"] = np.asarray(v)
readers = scale.build_scene_set(root + "/scenes", 2, (160, 160))
for r in scale.run_scaling(readers, DifetConfig(**{smoke}), ("harris", "fast"),
                           (1, 2), batch_tiles=4, mesh=mesh):
    out[f"scale/{{r['algorithm']}}/total_count"] = np.asarray(r["total_count"])
    out[f"scale/{{r['algorithm']}}/parity"] = np.asarray(r["parity"])
np.savez(sys.argv[3], **out)
"""


@pytest.fixture(scope="module")
def tiles():
    b = tile_scene(synthetic_scene(96, 96, seed=3), CFG)
    assert len(b) == 9
    return b.tiles, b.headers


@pytest.fixture(scope="module")
def jax_mesh(tiles, tmp_path_factory):
    """Every reference result of the module, from one process with 4 host
    devices whose XLA rounds once per operation."""
    root = tmp_path_factory.mktemp("jax_mesh")
    np.savez(root / "in.npz", tiles=tiles[0], headers=tiles[1])
    code = _JAX_MESH.format(
        cfg=dict(tile=CFG.tile, halo=CFG.halo,
                 max_keypoints_per_tile=CFG.max_keypoints_per_tile),
        dist_algorithms=DIST_ALGORITHMS,
        algorithms=",".join(PAPER_ALGORITHMS), stitch_geom=STITCH_GEOM,
        stitch_cfg=STITCH_CFG, smoke=SMOKE)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=str(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_max_isa=AVX")
    done = subprocess.run([sys.executable, "-c", code, str(root / "in.npz"),
                           str(root), str(root / "out.npz")], env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    with np.load(root / "out.npz") as z:
        out = {k: z[k] for k in z.files}
    assert int(out["devices"]) == 4
    return out


def _reference(ref, prefix):
    return {k[len(prefix):]: v for k, v in ref.items()
            if k.startswith(prefix)}


def assert_result_matches(got, want):
    """The reference's tolerances; exact fields equal."""
    got = {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
           for k, v in got.items()}
    assert set(got) == set(want)
    for key in ("total_count", "per_tile_count", "keypoint_count", "top_ys",
                "top_xs", "top_valid"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["top_scores"], want["top_scores"],
                               rtol=1e-5, atol=1e-7)
    if "top_desc" in want:
        if want["top_desc"].dtype == np.uint32:
            np.testing.assert_array_equal(got["top_desc"].view(np.uint32),
                                          want["top_desc"])
        else:
            np.testing.assert_allclose(got["top_desc"], want["top_desc"],
                                       rtol=0, atol=1e-5)


def assert_bitwise(got, want):
    assert set(got) == set(want)
    for key in want:
        a, b = (torch.as_tensor(np.asarray(x)) if not isinstance(
            x, torch.Tensor) else x for x in (got[key], want[key]))
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert torch.equal(a, b), key


# ---- against the reference on 4 host devices -------------------------------
@pytest.mark.parametrize("alg", DIST_ALGORITHMS)
def test_distributed_extractor_matches_reference(jax_mesh, tiles, alg):
    """``make_distributed_extractor`` on 8 tiles over 4 CPU entries: the
    reference's sharded run on 4 devices, and bit for bit the port's
    one-device ``extract_features``."""
    fn = engine.make_distributed_extractor(alg, CFG, CPU4, use_kernels=False)
    got = fn(tiles[0][:8], tiles[1][:8])
    assert_result_matches(got, _reference(jax_mesh, f"dist/{alg}/"))
    assert_bitwise(got, engine.extract_features(
        tiles[0][:8], tiles[1][:8], alg, CFG, use_kernels=False,
        device="cpu"))
    assert int(got["total_count"]) > 0


def test_job_on_a_mesh_matches_reference(jax_mesh, tiles, tmp_path):
    """``DifetJob(mesh=)`` on a bundle of 6 tiles (4 shards of 2, 2, 1, 1
    tiles, each split unevenly over 4 entries), all seven algorithms: the
    reference's padded sharded job, and bit for bit the one-device job."""
    algs = ",".join(PAPER_ALGORITHMS)
    results = {}
    for name, kw in (("mesh", dict(mesh=CPU4)), ("one", dict(device="cpu"))):
        store = BundleStore(tmp_path / name)
        store.put("b0", TileBundle(tiles[0][:6], tiles[1][:6], CFG))
        summary = DifetJob(store, algs, use_kernels=False, **kw).run()
        assert summary["bundles_done"] == 1
        results[name] = {alg: store.get_result(f"b0.{alg}")
                         for alg in PAPER_ALGORITHMS}
    for alg in PAPER_ALGORITHMS:
        assert_result_matches(results["mesh"][alg],
                              _reference(jax_mesh, f"job/{alg}/"))
        assert_bitwise(results["mesh"][alg], results["one"][alg])


def _match_store(path):
    n, size, overlap = STITCH_GEOM
    store, _ = stitch.build_overlapping_store(path, n, size, overlap,
                                              DifetConfig(**STITCH_CFG))
    DifetJob(store, "brief", shards_per_bundle=1, device="cpu").run()
    return store


def test_match_phase_on_a_mesh_matches_reference(jax_mesh, tmp_path):
    """``MatchPhase(mesh=)`` on 3 pairs over 4 CPU entries (one entry sits
    out): matches and inliers equal to the reference's on 4 devices,
    offsets and residuals within 1e-3 px; every pair result bit for bit
    the one-device phase's."""
    scenes = None
    out = {}
    for name, kw in (("mesh", dict(mesh=CPU4)), ("one", dict(device="cpu"))):
        store = _match_store(tmp_path / name)
        scenes = store.list()
        phase = mosaic.MatchPhase(store, list(zip(scenes, scenes[1:])),
                                  "brief", **kw)
        phase.run()
        out[name] = phase.results()
    assert len(out["mesh"]) == 3
    for (a, b), r in out["mesh"].items():
        want = _reference(jax_mesh, f"match/{a}__{b}/")
        assert int(r["n_matches"]) == int(want["n_matches"]) > 0
        np.testing.assert_allclose(r["t"], want["t"], atol=1e-3)
        assert int(r["n_inliers"]) == int(want["n_inliers"]) > 0
        np.testing.assert_allclose(r["rms"], want["rms"], atol=1e-3)
        for key in r:
            assert np.array_equal(r[key], out["one"][(a, b)][key]), key
            assert r[key].dtype == out["one"][(a, b)][key].dtype


def test_run_scaling_on_a_mesh_matches_reference(jax_mesh, tmp_path):
    """The reference's --smoke sweep with each batch of 4 split over 4
    entries: parity at every worker count, the reference's totals, and the
    per-batch counts of the one-device sweep."""
    readers = scale.build_scene_set(tmp_path / "scenes", 2, (160, 160))
    cfg = DifetConfig(**SMOKE)
    rows = scale.run_scaling(readers, cfg, ("harris", "fast"), (1, 2),
                             batch_tiles=4, mesh=CPU4)
    one = scale.run_scaling(readers, cfg, ("harris", "fast"), (1,),
                            batch_tiles=4, device="cpu")
    for row, row1 in zip(rows, one):
        alg = row["algorithm"]
        assert row["parity"] and bool(jax_mesh[f"scale/{alg}/parity"])
        assert row["total_count"] == int(jax_mesh[f"scale/{alg}/total_count"])
        assert row["batch_counts"] == row1["batch_counts"]
        assert row["total_count"] > 0


# ---- the two-stage reduce ---------------------------------------------------
def _random_per_tile(rng, t, k, d):
    """Candidates of t tiles: scores from a few values (ties within and
    across tiles), about half valid, some tiles all invalid."""
    scores = rng.choice(np.float32([0.25, 0.5, 0.75, 1.0]), (t, k))
    valid = rng.rand(t, k) < 0.5
    valid[rng.rand(t) < 0.3] = False
    return {"count": torch.from_numpy(rng.randint(0, 50, t).astype(np.int32)),
            "scores": torch.from_numpy(np.where(valid, scores, 0)
                                       .astype(np.float32)),
            "valid": torch.from_numpy(valid),
            "ys": torch.from_numpy(rng.randint(-5, 90, (t, k))
                                   .astype(np.int32)),
            "xs": torch.from_numpy(rng.randint(-5, 90, (t, k))
                                   .astype(np.int32)),
            "desc": torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31 - 1,
                                                 (t, k, d)).astype(np.int32))}


@pytest.mark.parametrize("seed", range(12))
def test_two_stage_reduce_equals_the_one_stage_reduce(seed):
    """``merge_reduced`` of `_local_reduce` over contiguous slices (1-5
    entries, some empty, some with t_i k < 4k, some all invalid, ties
    across entries) equals ``_reduce_features`` over the whole batch, bit
    for bit and dtype for dtype."""
    rng = np.random.RandomState(seed)
    t, k = int(rng.randint(1, 13)), int(rng.randint(1, 9))
    per_tile = _random_per_tile(rng, t, k, 3)
    n = int(rng.randint(1, 6))
    cuts = np.sort(rng.randint(0, t + 1, n - 1))
    bounds = [0, *cuts.tolist(), t]
    parts = [engine._local_reduce({key: v[lo:hi]
                                   for key, v in per_tile.items()})
             for lo, hi in zip(bounds, bounds[1:])]
    assert_bitwise(engine.merge_reduced(parts, k),
                   engine._reduce_features(per_tile))


def test_two_stage_reduce_with_one_entry_all_invalid():
    """One entry without a valid slot (only its -inf fills) beside entries
    whose valid slots do not fill the 4k: the fills come from the lowest
    flat indices, as in the one-stage reduce."""
    rng = np.random.RandomState(0)
    per_tile = _random_per_tile(rng, 6, 2, 1)
    per_tile["valid"][:2] = False
    per_tile["valid"][2:] = torch.from_numpy(rng.rand(4, 2) < 0.3)
    parts = [engine._local_reduce({key: v[lo:hi]
                                   for key, v in per_tile.items()})
             for lo, hi in ((0, 2), (2, 5), (5, 6))]
    assert_bitwise(engine.merge_reduced(parts, 2),
                   engine._reduce_features(per_tile))


# ---- the mesh itself --------------------------------------------------------
def test_mesh_entries_repeat_and_share_one_type():
    assert len(CPU4) == CPU4.size == 4 and CPU4.type == "cpu"
    assert CPU4.shape == {"data": 4} and dp_axes(CPU4) == ("data",)
    assert CPU4 == Mesh([torch.device("cpu")] * 4)
    assert hash(CPU4) == hash(Mesh(["cpu"] * 4))
    with pytest.raises(ValueError):
        Mesh([])
    host = make_host_mesh("cpu")
    assert host.axis_names == ("data", "model")
    assert host.shape == {"data": 1, "model": 1} and dp_axes(host) == ("data",)


def test_cuda_meshes_need_a_card():
    """``data_mesh`` never builds a CPU mesh quietly; on a host with cards
    it refuses counts outside [1, cards]."""
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        assert data_mesh().size == n and data_mesh(1)[0].index == 0
        for bad in (0, n + 1):
            with pytest.raises(ValueError):
                data_mesh(bad)
        return
    with pytest.raises(RuntimeError, match="cpu"):
        data_mesh()
    with pytest.raises(RuntimeError):
        Mesh(["cuda"])
    with pytest.raises(RuntimeError):
        make_host_mesh()


@pytest.mark.parametrize("n,size", [(6, 4), (8, 4), (3, 4), (0, 2), (7, 1)])
def test_split_rows_is_contiguous_in_mesh_order(n, size):
    mesh = Mesh(["cpu"] * size)
    bounds = split_rows(n, mesh)
    assert len(bounds) == size and bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    sizes = [hi - lo for lo, hi in bounds]
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes,
                                                            reverse=True)
    x = np.arange(n * 2).reshape(n, 2)
    s = shard(x, mesh)
    assert isinstance(s, Sharded) and s.shape == (n, 2) and len(s) == n
    assert np.array_equal(np.concatenate([p.numpy() for p in s.parts]), x)
    assert shard(s, mesh) is s
    with pytest.raises(ValueError):
        shard(s, Mesh(["cpu"] * (size + 1)))


def test_runner_raises_a_failure_on_any_entry():
    """A failure on one entry is raised in the caller; nothing carries on
    without it."""
    def work(i):
        if i == 2:
            raise RuntimeError("entry 2 failed")
        yield "x", {"v": torch.tensor([i])}

    with pytest.raises(RuntimeError, match="entry 2"):
        MeshRunner(CPU4).run(work, range(4))


def test_runner_issues_the_entries_in_turn():
    """The calling thread issues one step of each entry in turn, and each
    entry's results come back in entry order, on the mesh's first
    device."""
    order = []

    def work(i):
        for step in range(i + 1):
            order.append((i, step))
            yield f"s{step}", {"v": torch.tensor([i, step])}

    got = MeshRunner(CPU4).run(work, [0, 1, 3])
    assert order == [(0, 0), (1, 0), (3, 0), (1, 1), (3, 1), (3, 2),
                     (3, 3)]
    assert [sorted(g) for g in got] == [["s0"], ["s0", "s1"],
                                        ["s0", "s1", "s2", "s3"]]
    assert got[2]["s3"]["v"].tolist() == [3, 3]


def test_launch_counts_are_exact_under_threads():
    """``CudaKernel``'s counts are taken under a lock: 8 threads counting
    at once on two devices lose no launch."""
    k = CudaKernel("harris", "difet_harris", [])

    def count(i):
        for _ in range(2000):
            k.count(i % 2)

    threads = [threading.Thread(target=count, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert k.launches == 16000 and dict(k.launches_by_device) == {0: 8000,
                                                                  1: 8000}
    k.reset()
    assert k.launches == 0 and not k.launches_by_device


def test_prefetcher_stages_sharded_batches(tiles):
    """``Prefetcher(mesh=)`` hands over each array cut into the mesh's row
    slices; the extractor takes them as they are, and the result is the
    one-device run's."""
    mesh = Mesh(["cpu"] * 3)
    bundles = [TileBundle(tiles[0][i:i + 4], tiles[1][i:i + 4], CFG)
               for i in (0, 4)]
    fn = engine.make_distributed_multi_extractor(("fast", "brief"), CFG,
                                                 mesh)
    with Prefetcher(iter(enumerate(bundles)), device_put=True,
                    mesh=mesh) as pf:
        staged = list(pf)
    assert [i for i, _ in staged] == [0, 1]
    for (_, b), want in zip(staged, bundles):
        assert isinstance(b.tiles, Sharded) and b.tiles.mesh == mesh
        assert [len(p) for p in b.tiles.parts] == [2, 1, 1]
        got = fn(b.tiles, b.headers)
        ref = engine.extract_features_multi(want.tiles, want.headers,
                                            ("fast", "brief"), CFG,
                                            device="cpu")
        for alg in ("fast", "brief"):
            assert_bitwise(got[alg], ref[alg])
    with pytest.raises(ValueError):
        Prefetcher(iter(()), device_put=True, device="cpu", mesh=mesh)


def test_jobs_take_a_device_or_a_mesh(tmp_path):
    with pytest.raises(ValueError):
        mosaic.MatchPhase(BundleStore(tmp_path / "s"), [], "brief",
                          device="cpu", mesh=CPU4)
    with pytest.raises(ValueError):
        DifetJob(BundleStore(tmp_path / "s"), "harris", device="cpu",
                 mesh=CPU4)


def test_a_mesh_of_one_entry_runs_the_one_device_code(tmp_path, monkeypatch):
    """As the reference's ``_shard_batch`` does, a mesh of one entry takes
    the one-device code on its device: the job, the match phase and the
    sweep (its prefetcher stages onto the device, not the mesh); a mesh
    that lists one device more than once keeps the split."""
    one = Mesh(["cpu"])
    cpu = torch.device("cpu")
    assert one_device(one) == (None, cpu)
    assert one_device(None, "cuda:1") == (None, "cuda:1")
    assert one_device(Mesh(["cpu"] * 2)) == (Mesh(["cpu"] * 2), None)
    job = DifetJob(BundleStore(tmp_path / "s"), "harris", mesh=one)
    assert job.mesh is None and job.device == cpu
    phase = mosaic.MatchPhase(BundleStore(tmp_path / "s"), [], "brief",
                              mesh=one)
    assert phase.mesh is None and phase.device == cpu
    staged = []

    class Recording(Prefetcher):
        def __init__(self, *a, **kw):
            staged.append(kw)
            super().__init__(*a, **kw)

    monkeypatch.setattr(scale, "Prefetcher", Recording)
    readers = scale.build_scene_set(tmp_path / "scenes", 1, (160, 160))
    cfg = DifetConfig(**SMOKE)
    rows = scale.run_scaling(readers, cfg, ("harris",), (1,), batch_tiles=4,
                             mesh=one)
    want = scale.run_scaling(readers, cfg, ("harris",), (1,), batch_tiles=4,
                             device="cpu")
    assert staged and all(kw.get("mesh") is None and kw["device"] == cpu
                          for kw in staged)
    assert rows[0]["batch_counts"] == want[0]["batch_counts"]


def test_host_mesh_refuses_an_indexed_device(tmp_path):
    """``make_host_mesh`` takes every card: ``cuda:1`` names one, so it
    raises rather than drop the index, and the stitch asks for ``--mesh
    none`` before it builds anything."""
    with pytest.raises(ValueError, match="cuda:1"):
        make_host_mesh("cuda:1")
    with pytest.raises(SystemExit) as e:
        stitch.main(["--store", str(tmp_path / "st"), "--device", "cuda:1"])
    assert e.value.code == 2 and not (tmp_path / "st").exists()
