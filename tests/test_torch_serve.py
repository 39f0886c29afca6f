"""The port's feature service (``repro_torch.serve``) on the CPU: buckets,
the LRU cache, the scheduler, served parity, determinism — the cases of
``tests/test_serve.py`` against the port — plus the port's own:

* the vectorised request reduce (`core/engine.py::extract_request_features`)
  bit for bit against the per-row loop it replaced, and against JAX's;
* `serve/trace.py`'s tiles and events bitwise against the reference's;
* served responses against the JAX ``FeatureService(use_pallas=False)`` on
  the same tiles: counts, keypoints and descriptor bits exact, floats
  within rtol 1e-5 / atol 1e-6;
* the output packing a CUDA graph's step is copied back through.

Every service runs with ``device="cpu"`` (the step runs eagerly; the CUDA
graphs are held on the card by ``chip_smoke.py`` phase 3d).
"""
import dataclasses
import functools
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import Future
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.difet_paper import DifetConfig as JaxConfig
from repro.core import engine as jengine
from repro.serve import trace as jtrace
from repro_torch.configs.difet_paper import DifetConfig, PAPER_ALGORITHMS
from repro_torch.core import engine
from repro_torch.core.bundle import tile_scene
from repro_torch.core.job import DifetJob
from repro_torch.data.landsat import synthetic_scene
from repro_torch.serve import (BatchScheduler, BucketTable, FeatureService,
                               ReplicaDied, ResultCache, ServeConfig,
                               ServiceClosed, ServiceOverloaded, WorkItem,
                               config_digest, encode_tile, tile_digest)
from repro_torch.serve import buckets as B
from repro_torch.serve import trace as strace

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

BASE = DifetConfig(tile=32, halo=8, max_keypoints_per_tile=16)
ALGS = ("harris", "shi_tomasi")


def make_service(max_batch=4, cache_entries=128, buckets=(32,),
                 max_pending=1024):
    return FeatureService(ServeConfig(
        base=BASE, buckets=buckets, max_batch=max_batch,
        max_batch_delay_s=0.005, max_pending=max_pending,
        cache_entries=cache_entries, device="cpu"))


@pytest.fixture(scope="module")
def service():
    svc = make_service()
    yield svc
    svc.close()


@pytest.fixture
def rng():
    return np.random.RandomState(0)


# ---- algorithm normalization ------------------------------------------------

def test_normalize_algorithms_dedupes_preserving_order():
    assert engine.normalize_algorithms("fast, brief,fast,orb") == \
        ("fast", "brief", "orb")
    assert engine.normalize_algorithms(("harris",)) == ("harris",)


def test_normalize_algorithms_rejects_unknown_listing_choices():
    with pytest.raises(ValueError) as e:
        engine.normalize_algorithms("harris,bogus")
    msg = str(e.value)
    assert "bogus" in msg
    for name in engine.ALGORITHMS:
        assert name in msg
    with pytest.raises(ValueError):
        engine.normalize_algorithms(" , ")


# ---- buckets ---------------------------------------------------------------

def test_bucket_selection():
    table = BucketTable((32, 64, 128), BASE)
    assert table.bucket_for(20, 31) == 32
    assert table.bucket_for(32, 33) == 64
    assert table.bucket_for(65, 10) == 128
    assert table.bucket_for(129, 5) is None


def test_pad_to_bucket_matches_tile_scene_bitwise(rng):
    table = BucketTable((32, 64), BASE)
    for h, w, bucket in [(32, 32, 32), (30, 25, 32), (33, 20, 64),
                         (9, 64, 64)]:
        gray = rng.rand(h, w).astype(np.float32)
        tile, header = table.pad_to_bucket(gray, bucket)
        ref = tile_scene(gray, table.cfg_for(bucket))
        assert np.array_equal(tile, ref.tiles[0])
        assert np.array_equal(header, ref.headers[0])


def test_pad_to_bucket_sub_halo_tiles_use_multibounce_fallback(rng):
    table = BucketTable((32,), BASE)      # halo 8
    gray = rng.rand(5, 32).astype(np.float32)
    tile, header = table.pad_to_bucket(gray, 32)
    ref = tile_scene(gray, table.cfg_for(32))
    assert np.array_equal(tile, ref.tiles[0])
    assert np.array_equal(header, ref.headers[0])
    with pytest.raises(ValueError, match="too small"):
        table.pad_to_bucket(rng.rand(1, 32).astype(np.float32), 32)


# ---- result cache ----------------------------------------------------------

def _entry(i):
    return {"top_scores": np.full((4,), float(i), np.float32)}


def test_cache_lru_eviction_order():
    c = ResultCache(capacity=3)
    for k in "abc":
        c.put(k, _entry(0))
    assert c.get("a") is not None        # LRU order b, c, a
    c.put("d", _entry(1))                # evicts 'b'
    assert c.get("b") is None
    assert c.get("a") is not None and c.get("c") is not None
    assert c.get("d") is not None
    assert c.evictions == 1 and len(c) == 3


def test_cache_entries_are_frozen_copies():
    c = ResultCache(capacity=2)
    src = {"x": np.ones((3,), np.float32)}
    stored = c.put("k", src)
    src["x"][0] = 99.0
    assert c.get("k")["x"][0] == 1.0
    with pytest.raises(ValueError):
        stored["x"][0] = 5.0
    assert c.get("k")["x"].shape == (3,)
    zero_d = c.put("z", {"n": np.int32(7)})
    assert zero_d["n"].shape == ()


def test_cache_capacity_zero_disables():
    c = ResultCache(capacity=0)
    c.put("k", _entry(0))
    assert c.get("k") is None and len(c) == 0


def test_config_digest_collision_safety():
    d1 = config_digest(BASE, use_kernels=True)
    assert config_digest(BASE, use_kernels=True) == d1
    assert config_digest(dataclasses.replace(BASE, harris_k=0.05)) != d1
    assert config_digest(dataclasses.replace(BASE, tile=64)) != d1
    assert config_digest(BASE, use_kernels=False) != d1
    c = ResultCache(capacity=8)
    c.put((tile_digest(np.zeros((4, 4))), "harris", d1), _entry(0))
    other = config_digest(dataclasses.replace(BASE, harris_k=0.05))
    assert c.get((tile_digest(np.zeros((4, 4))), "harris", other)) is None


def test_disk_tier_atomic_write_and_torn_file(tmp_path):
    """The shared disk tier: an entry reads back as written, no tmp file
    is left behind, and a torn entry file reads as a miss, never an
    error."""
    from repro_torch.serve import DiskCacheTier
    tier = DiskCacheTier(str(tmp_path))
    entry = {"top_ys": np.arange(4, dtype=np.int32),
             "total_count": np.int64(3)}
    tier.put(("d", "harris", "c"), entry)
    got = tier.get(("d", "harris", "c"))
    assert np.array_equal(got["top_ys"], entry["top_ys"])
    assert int(got["total_count"]) == 3
    assert not list(tmp_path.rglob("*.tmp*"))       # no tmp left behind
    [path] = [p for p in tmp_path.rglob("*") if p.is_file()]
    path.write_bytes(path.read_bytes()[:10])        # torn
    assert tier.get(("d", "harris", "c")) is None


# ---- service: parity, cache, partial hits ----------------------------------

def _direct(table, gray, algs):
    bucket = table.bucket_for(*gray.shape)
    tile, header = table.pad_to_bucket(gray, bucket)
    out = engine.extract_features_multi(tile[None], header[None], algs,
                                        table.cfg_for(bucket), device="cpu")
    return {alg: {k: v.numpy() for k, v in res.items()}
            for alg, res in out.items()}


def assert_results_equal(a, b):
    assert set(a) == set(b)
    for alg in a:
        assert set(a[alg]) == set(b[alg])
        for k in a[alg]:
            x, y = np.asarray(a[alg][k]), np.asarray(b[alg][k])
            assert x.shape == y.shape and x.dtype == y.dtype, (alg, k)
            assert np.array_equal(x, y), (alg, k)


def test_served_parity(service):
    """Served results are bit-identical to direct engine calls, whatever
    batch the scheduler rode them in."""
    tiles = [synthetic_scene(32, 32, s) for s in range(6)]
    resps = [h.result(60) for h in
             [service.submit(t, ALGS) for t in tiles]]
    for t, r in zip(tiles, resps):
        assert_results_equal(_direct(service.table, t, ALGS), r.results)
        assert r.n_tiles == 1 and r.bucket == 32
        assert r.timing["latency_s"] >= 0.0
        assert r.timing["batch_sizes"] and r.timing["batch_sizes"][0] >= 1
        for v in r.results["harris"].values():
            assert not np.asarray(v).flags.writeable   # read-only


def test_repeat_requests_served_from_cache(service):
    tile = synthetic_scene(32, 32, 77)
    first = service.extract(tile, ALGS, timeout=60)
    assert not first.fully_cached
    hits_before = service.cache.hits
    again = service.extract(tile, ALGS, timeout=60)
    assert again.fully_cached
    assert again.cached == {a: 1.0 for a in ALGS}
    assert service.cache.hits >= hits_before + len(ALGS)
    assert_results_equal(first.results, again.results)


def test_partial_algorithm_cache_hit(service):
    tile = synthetic_scene(32, 32, 123)
    service.extract(tile, ("harris",), timeout=60)
    r = service.extract(tile, ALGS, timeout=60)
    assert r.cached["harris"] == 1.0 and r.cached["shi_tomasi"] == 0.0
    assert_results_equal(_direct(service.table, tile, ALGS), r.results)


def test_wire_format_and_scene_id(service):
    tile = synthetic_scene(32, 32, 5)
    via_bytes = service.extract(encode_tile(tile), ("harris",), timeout=60)
    service.register_scene("granule-5", tile)
    via_id = service.extract("granule-5", ("harris",), timeout=60)
    assert_results_equal(via_bytes.results, via_id.results)
    with pytest.raises(KeyError):
        service.submit("nope", ("harris",))


def test_scene_request_splits_and_merges(service):
    """Oversize image → largest-bucket tiles, merged with the batch job's
    reduce; bit-identical to the per-tile engine results merged."""
    scene = synthetic_scene(70, 70, 9)
    cfg = service.table.cfg_for(32)
    b = tile_scene(scene, cfg)
    per = {k: v.numpy() for k, v in engine.extract_request_features(
        b.tiles, b.headers, ("harris",), cfg, device="cpu")["harris"].items()}
    want = DifetJob._merge([{k: v[i] for k, v in per.items()}
                            for i in range(len(b))])
    r = service.submit(scene, "harris").result(60)
    assert r.n_tiles == len(b) == 9
    assert_results_equal({"harris": want}, r.results)


def test_algorithm_order_canonicalized_one_program():
    svc = make_service(max_batch=4, cache_entries=64)
    try:
        r1 = svc.extract(synthetic_scene(32, 32, 200),
                         ("shi_tomasi", "harris"), timeout=60)
        r2 = svc.extract(synthetic_scene(32, 32, 201),
                         ("harris", "shi_tomasi"), timeout=60)
        assert r1.algorithms == ("shi_tomasi", "harris")
        assert r2.algorithms == ("harris", "shi_tomasi")
        assert svc.compile_cache.keys() == [(32, ("harris", "shi_tomasi"))]
        assert_results_equal(
            _direct(svc.table, synthetic_scene(32, 32, 200),
                    ("shi_tomasi", "harris")), r1.results)
    finally:
        svc.close()


def test_warmup_builds_each_pair_exactly_once():
    svc = make_service(max_batch=2, cache_entries=0)
    try:
        assert svc.warmup([("harris",)]) == 1
        assert svc.warmup([("harris",)]) == 1
        for s in range(3):
            svc.extract(synthetic_scene(32, 32, s), ("harris",), timeout=60)
        assert svc.compile_cache.programs == 1
        assert svc.compile_cache.keys() == [(32, ("harris",))]
        assert isinstance(svc.compile_cache.get(32, ("harris",)),
                          B.EagerStep)
    finally:
        svc.close()


def test_service_without_cuda_raises():
    """The card is the default device: without CUDA and without
    ``device="cpu"`` the service refuses to start instead of running
    eagerly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA, so the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FeatureService(ServeConfig(base=BASE, buckets=(32,)))


# ---- determinism -----------------------------------------------------------

def test_arrival_order_determinism():
    tiles = [synthetic_scene(32, 32, 40 + s) for s in range(10)]
    orders = [list(range(10)), [9, 3, 1, 7, 5, 0, 8, 2, 6, 4]]
    outcomes = []
    for order in orders:
        svc = make_service(max_batch=4, cache_entries=0)
        try:
            handles = {i: svc.submit(tiles[i], ("harris",)) for i in order}
            outcomes.append({i: handles[i].result(60).results
                             for i in order})
        finally:
            svc.close()
    for i in range(10):
        assert_results_equal(outcomes[0][i], outcomes[1][i])


# ---- latency accounting -----------------------------------------------------

def test_open_loop_latency_not_inflated_by_drain_order():
    svc = make_service(max_batch=1, cache_entries=0)
    try:
        svc.warmup([("harris",)])
        delay = 0.08
        orig = svc._run_batch

        def slow(bucket, algs, items):
            time.sleep(delay)
            orig(bucket, algs, items)

        svc.scheduler._run_batch = slow
        tiles = [synthetic_scene(32, 32, 400 + s) for s in range(4)]
        submit_t0 = time.perf_counter()
        handles = [svc.submit(t, ("harris",)) for t in tiles]
        deadline = time.monotonic() + 60
        while not all(h.done() for h in handles):
            assert time.monotonic() < deadline
            time.sleep(0.01)
        time.sleep(0.3)
        lats = [h.result(60).timing["latency_s"] for h in handles]
        drain_wall = time.perf_counter() - submit_t0
        assert drain_wall > 0.3
        assert lats[0] < 0.3 < drain_wall
        assert lats[-1] >= lats[0]
        for r in [h.result(60) for h in handles]:
            assert r.timing["completed_at"] >= r.timing["enqueued_at"]
    finally:
        svc.close()


def test_fully_cached_response_reports_zero_queue_latency():
    svc = make_service(max_batch=2, cache_entries=64)
    try:
        tile = synthetic_scene(32, 32, 900)
        svc.extract(tile, ("harris",), timeout=60)
        r = svc.extract(tile, ("harris",), timeout=60)
        assert r.fully_cached
        assert r.timing["completed_at"] == r.timing["enqueued_at"]
        assert r.timing["latency_s"] == 0.0
    finally:
        svc.close()


# ---- scheduler: backpressure + coalescing ----------------------------------

def test_scheduler_backpressure():
    release = threading.Event()

    def blocking_runner(bucket, algs, items):
        release.wait(30)
        for it in items:
            it.future.set_result(("ok", it.batch_size))

    sched = BatchScheduler(blocking_runner, max_batch=1,
                           max_batch_delay_s=0.0, max_pending=2)
    tile = np.zeros((4, 4), np.float32)
    header = np.zeros((6,), np.int32)
    futures, rejected = [], 0
    for _ in range(6):
        try:
            futures.append(sched.submit(tile, header, 4, ("harris",)))
        except ServiceOverloaded:
            rejected += 1
    assert rejected >= 1
    assert sched.stats()["rejected"] == rejected
    release.set()
    for f in futures:
        assert f.result(30)[0] == "ok"
    sched.stop(10)


def test_concurrent_identical_requests_coalesce():
    svc = make_service(max_batch=4, cache_entries=128)
    try:
        svc.warmup([("harris",)])
        tile = synthetic_scene(32, 32, 314)
        h1 = svc.submit(tile, ("harris",))
        h2 = svc.submit(tile, ("harris",))
        r1, r2 = h1.result(60), h2.result(60)
        assert_results_equal(r1.results, r2.results)
        assert svc.scheduler.items == 1
    finally:
        svc.close()


def test_identical_tiles_at_different_positions_never_alias():
    svc = make_service(cache_entries=128)
    try:
        svc.warmup([("harris",)])
        gray = synthetic_scene(32, 32, seed=99)
        tile, header0 = svc.table.pad_to_bucket(gray, 32)
        header1 = header0.copy()
        header1[1], header1[2] = 2, 3
        cfgd = svc._cfg_digest(32)

        def run(header):
            part = svc._submit_tile(tile, header, 32, ("harris",), cfgd,
                                    block=True)
            res = dict(part.cached)
            if part.future is not None:
                computed, _, _ = part.future.result(60)
                res.update(computed)
            return res["harris"]

        r0, r1 = run(header0), run(header1)
        valid = np.asarray(r0["top_valid"]).astype(bool)
        assert valid.any()
        t = svc.table.cfg_for(32).tile
        np.testing.assert_array_equal(np.asarray(r1["top_ys"])[valid],
                                      np.asarray(r0["top_ys"])[valid] + 2 * t)
        np.testing.assert_array_equal(np.asarray(r1["top_xs"])[valid],
                                      np.asarray(r0["top_xs"])[valid] + 3 * t)
    finally:
        svc.close()


# ---- shutdown + burst overflow ---------------------------------------------

def test_stop_wakes_blocked_submitters():
    release = threading.Event()

    def runner(bucket, algs, items):
        release.wait(30)
        for it in items:
            it.future.set_result("ok")

    sched = BatchScheduler(runner, max_batch=1, max_batch_delay_s=0.0,
                           max_pending=1)
    tile = np.zeros((4, 4), np.float32)
    header = np.zeros((6,), np.int32)
    f1 = sched.submit(tile, header, 4, ("harris",))
    deadline = time.monotonic() + 10
    while sched.queue_depth and time.monotonic() < deadline:
        time.sleep(0.001)
    f2 = sched.submit(tile, header, 4, ("harris",))
    woke = []

    def blocked_submitter():
        try:
            sched.submit(tile, header, 4, ("harris",), block=True,
                         timeout=30)
        except ServiceClosed as e:
            woke.append(e)

    t = threading.Thread(target=blocked_submitter)
    t.start()
    time.sleep(0.1)
    sched.stop(timeout=0.1)
    t.join(5)
    assert not t.is_alive(), "blocked submitter hung across stop()"
    assert len(woke) == 1
    with pytest.raises(ServiceClosed):
        sched.submit(tile, header, 4, ("harris",))
    release.set()
    assert f1.result(30) == "ok"
    assert f2.result(30) == "ok"
    sched.stop(10)


def test_burst_overflow_sheds_under_concurrent_submitters():
    step_lock = threading.Lock()
    svc = FeatureService(ServeConfig(
        base=BASE, buckets=(32,), max_batch=4, max_batch_delay_s=0.001,
        max_pending=8, cache_entries=0, device="cpu"), step_lock=step_lock)
    try:
        svc.warmup([("harris",)])
        tiles = [synthetic_scene(32, 32, 500 + i) for i in range(48)]
        handles, sheds, lock = [], [], threading.Lock()

        def client(chunk):
            for tile in chunk:
                try:
                    h = svc.submit(tile, ("harris",))
                except ServiceOverloaded:
                    with lock:
                        sheds.append(1)
                else:
                    with lock:
                        handles.append(h)

        with step_lock:
            threads = [threading.Thread(target=client, args=(tiles[i::8],))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
        assert not any(t.is_alive() for t in threads)
        assert len(sheds) >= 1
        assert len(handles) + len(sheds) == len(tiles)
        assert svc.shed == len(sheds)
        assert svc.requests == len(handles)
        for h in handles:
            assert int(h.result(60).results["harris"]["total_count"]) >= 0
    finally:
        svc.close()


def test_service_stats_flat_snapshot():
    svc = make_service(max_batch=4, cache_entries=64)
    try:
        svc.warmup([("harris",)])
        tile = synthetic_scene(32, 32, 907)
        svc.submit(tile, ("harris",), block=True).result(60)
        svc.submit(tile, ("harris",), block=True).result(60)
        s = svc.stats()
        for key in ("name", "submitted", "shed", "cache_hits",
                    "cache_misses", "queue_depth", "batches",
                    "batch_occupancy", "p50_queue_ms", "p99_queue_ms",
                    "busy_s", "steps"):
            assert key in s, key
        assert s["submitted"] == 2 and s["shed"] == 0
        assert s["cache_hits"] >= 1 and s["cache_misses"] >= 1
        assert s["steps"] >= 1 and s["busy_s"] > 0.0
        assert 0.0 < s["batch_occupancy"] <= 1.0
        assert s["p99_queue_ms"] >= s["p50_queue_ms"] >= 0.0
    finally:
        svc.close()


def test_work_item_settlement_is_idempotent_first_wins():
    def item():
        return WorkItem(seq=0, tile=np.zeros((32, 32), np.float32),
                        header=np.zeros(6, np.int32), bucket=32,
                        algorithms=("harris",), digest="d",
                        cfg_digest="c", future=Future())

    it = item()
    assert it.resolve("first") and not it.resolve("second")
    assert not it.fail(ReplicaDied("late kill"))
    assert it.future.result(0) == "first"
    it = item()
    assert it.fail(ReplicaDied("kill won")) and not it.resolve("late batch")
    with pytest.raises(ReplicaDied):
        it.future.result(0)
    for _ in range(20):
        it = item()
        start = threading.Barrier(8)
        wins = []

        def run(op, tag):
            start.wait()
            if op():
                wins.append(tag)
        threads = (
            [threading.Thread(target=run,
                              args=((lambda i=i: it.resolve(f"r{i}")),
                                    "resolve")) for i in range(4)] +
            [threading.Thread(target=run,
                              args=((lambda i=i: it.fail(
                                  ReplicaDied(f"f{i}"))), "fail"))
             for i in range(4)])
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        assert len(wins) == 1, wins
        if wins[0] == "resolve":
            assert str(it.future.result(0)).startswith("r")
        else:
            with pytest.raises(ReplicaDied):
                it.future.result(0)


def test_scheduler_kill_vs_completion_race_single_outcome():
    release = threading.Event()

    def slow_runner(bucket, algorithms, batch):
        release.wait(10)
        for it in batch:
            it.resolve({"ok": it.seq})

    sched = BatchScheduler(slow_runner, max_batch=4,
                           max_batch_delay_s=0.001, max_pending=64,
                           name="settle-race")
    futs = [sched.submit(np.zeros((32, 32), np.float32), np.zeros(6),
                         32, ("harris",)) for _ in range(4)]
    deadline = time.monotonic() + 5.0
    while not sched._active and time.monotonic() < deadline:
        time.sleep(0.002)
    killer = threading.Thread(target=sched.kill)
    killer.start()
    release.set()
    killer.join(10)
    assert not killer.is_alive()
    outcomes = []
    for f in futs:
        try:
            outcomes.append(("ok", f.result(10)))
        except Exception as e:  # noqa: BLE001
            outcomes.append(("died", type(e).__name__))
    assert len(outcomes) == 4
    for kind, val in outcomes:
        assert kind in ("ok", "died")
        if kind == "died":
            assert val == "ReplicaDied"


# ---- the vectorised request reduce -----------------------------------------

SMALL = dict(tile=32, halo=16, max_keypoints_per_tile=32)


@pytest.fixture(scope="module")
def request_batch():
    cfg = DifetConfig(**SMALL)
    b = tile_scene(synthetic_scene(96, 96, seed=3), cfg)
    headers = b.headers[:6].copy()
    headers[5, 5] = 1                       # one padding row
    return b.tiles[:6], headers


def _row_loop(per_tile):
    """The per-row reduce the vectorised one replaced (the oracle)."""
    rows = [engine._reduce_features({k: v[i:i + 1]
                                     for k, v in per_tile.items()})
            for i in range(per_tile["count"].shape[0])]
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


@pytest.mark.parametrize("alg", PAPER_ALGORITHMS)
def test_request_reduce_equals_the_row_loop(request_batch, alg):
    tiles, headers = request_batch
    cfg = DifetConfig(**SMALL)
    per = engine._map(tiles, headers, (alg,), cfg, True, "cpu")[alg]
    want = _row_loop(per)
    got = engine.extract_request_features(tiles, headers, (alg,), cfg,
                                          device="cpu")[alg]
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k
    assert int(got["keypoint_count"][5]) == 0      # the padding row


def test_request_features_match_jax(request_batch):
    """Against the reference's vmapped per-request reduce, at
    ``test_torch_engine.py``'s tolerances."""
    tiles, headers = request_batch
    algs = ("shi_tomasi", "sift", "surf", "orb")
    want = jax.jit(functools.partial(
        jengine.extract_request_features, algorithms=algs,
        cfg=JaxConfig(**SMALL)))(tiles, headers)
    got = engine.extract_request_features(tiles, headers, algs,
                                          DifetConfig(**SMALL), device="cpu")
    for alg in algs:
        assert_close_to_jax({k: v.numpy() for k, v in got[alg].items()},
                            {k: np.asarray(v) for k, v in want[alg].items()},
                            score_atol=1e-7, desc_atol=1e-5)


def assert_close_to_jax(got, want, score_atol, desc_atol):
    assert set(got) == set(want)
    for key in ("total_count", "per_tile_count", "keypoint_count", "top_ys",
                "top_xs", "top_valid"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["top_scores"], want["top_scores"],
                               rtol=1e-5, atol=score_atol)
    if "top_desc" in want:
        if want["top_desc"].dtype == np.uint32:
            np.testing.assert_array_equal(got["top_desc"],
                                          want["top_desc"].view(np.int32))
        else:
            np.testing.assert_allclose(got["top_desc"], want["top_desc"],
                                       rtol=1e-5, atol=desc_atol)


# ---- served against the JAX service ----------------------------------------

SERVED_SETS = (("harris", "shi_tomasi"), ("brief", "fast", "orb"))
SERVE_KW = dict(max_batch=4, max_batch_delay_s=0.005, cache_entries=0,
                buckets=(32,))
_JAX_SERVICE = """
import sys
import numpy as np
from repro.configs.difet_paper import DifetConfig
from repro.data.landsat import synthetic_scene
from repro.serve import FeatureService, ServeConfig
svc = FeatureService(ServeConfig(base=DifetConfig(**{small}),
                                 use_pallas=False, **{kw}))
out = {{}}
for algs in {sets}:
    tiles = [synthetic_scene(32, 32, 60 + s) for s in range(3)]
    tiles.append(synthetic_scene(27, 30, 64))
    for i, h in enumerate([svc.submit(t, algs) for t in tiles]):
        for alg, res in h.result(300).results.items():
            for k, v in res.items():
                out[f"{{'+'.join(algs)}}/{{i}}/{{alg}}/{{k}}"] = np.asarray(v)
svc.close()
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_served(tmp_path_factory):
    """The reference service's responses, from a process whose XLA rounds
    once per operation (``--xla_cpu_max_isa=AVX``, as the port does): on a
    CPU with FMA, XLA contracts the reference's blurs, which flips an
    occasional BRIEF/ORB bit (and SIFT count, ``reference_counts.json``)
    against any exactly rounded computation."""
    path = tmp_path_factory.mktemp("jax_served") / "served.npz"
    code = _JAX_SERVICE.format(small=SMALL, kw=SERVE_KW, sets=SERVED_SETS)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=AVX",
               PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    done = subprocess.run([sys.executable, "-c", code, str(path)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("algs", SERVED_SETS)
def test_served_matches_the_jax_service(jax_served, algs):
    """The same tiles through the port's service and the reference's
    ``FeatureService(use_pallas=False)`` at bucket 32 (halo 16, K 32):
    counts, keypoints and descriptor bits exact, scores and float
    descriptors within rtol 1e-5 / atol 1e-6."""
    ours = FeatureService(ServeConfig(base=DifetConfig(**SMALL),
                                      device="cpu", **SERVE_KW))
    try:
        tiles = [synthetic_scene(32, 32, 60 + s) for s in range(3)]
        tiles.append(synthetic_scene(27, 30, 64))   # a partial tile
        got = [h.result(120) for h in [ours.submit(t, algs) for t in tiles]]
    finally:
        ours.close()
    for i, g in enumerate(got):
        assert g.algorithms == algs and g.bucket == 32
        for alg in algs:
            prefix = f"{'+'.join(algs)}/{i}/{alg}/"
            want = {k[len(prefix):]: v for k, v in jax_served.items()
                    if k.startswith(prefix)}
            assert_close_to_jax(g.results[alg], want, score_atol=1e-6,
                                desc_atol=1e-6)


# ---- the trace generator ---------------------------------------------------

@pytest.mark.parametrize("arrival", ["uniform", "poisson", "burst"])
def test_trace_and_pool_equal_the_reference(arrival):
    kw = dict(n_requests=200, seed=3, arrival=arrival, rate=300.0,
              tile_sizes=(32, 64, 128, 256), unique_scenes=6,
              algorithm_sets=(("harris",), ("brief", "fast", "orb")),
              tenants=("a", "b"), tenant_weights=(0.7, 0.3))
    ours = strace.make_trace(strace.TraceConfig(**kw))
    ref = jtrace.make_trace(jtrace.TraceConfig(**kw))
    assert [dataclasses.astuple(e) for e in ours] == \
        [dataclasses.astuple(e) for e in ref]
    assert [strace.scene_key(e) for e in ours] == \
        [jtrace.scene_key(e) for e in ref]
    if arrival == "uniform":
        pool = strace.tile_pool(strace.TraceConfig(**kw))
        ref_pool = jtrace.tile_pool(jtrace.TraceConfig(**kw))
        assert pool.keys() == ref_pool.keys()
        for key, tile in pool.items():
            assert tile.dtype == ref_pool[key].dtype
            assert np.array_equal(tile, ref_pool[key]), key


# ---- the CUDA graph's output packing ----------------------------------------

def test_packed_outputs_round_trip_bitwise(request_batch):
    """The bytes a captured step copies back unpack to the step's outputs
    exactly, every dtype (f32, i32, i64, bool) aligned for its type."""
    tiles, headers = request_batch
    step = engine.make_serve_step(PAPER_ALGORITHMS, DifetConfig(**SMALL),
                                  device="cpu")
    out = step(torch.from_numpy(tiles), torch.from_numpy(headers))
    packed, layout = B.pack_outputs(out)
    assert packed.dtype == torch.uint8 and packed.ndim == 1
    raw = packed.numpy().copy()
    back = B.unpack_outputs(raw, layout)
    for _, _, offset, _, dtype, _ in layout:
        assert offset % dtype.itemsize == 0
    assert_results_equal({a: {k: v.numpy() for k, v in r.items()}
                          for a, r in out.items()}, back)
    assert {v.dtype for r in back.values() for v in r.values()} == {
        np.dtype(np.float32), np.dtype(np.int32), np.dtype(np.int64),
        np.dtype(np.bool_)}
