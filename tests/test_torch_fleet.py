"""The port's thread fleet (``repro_torch.serve.{router,fleet}``) on the CPU:
consistent hashing, admission control, affinity, the replica lifecycle,
lease liveness, the autoscaler and chaos — the cases of
``tests/test_fleet.py`` against the port, each held to the JAX package
where the two can be compared:

* the hash ring routes every key to the replica the reference's ring
  picks, before and after a replica leaves;
* token buckets and typed sheds take the reference's decisions;
* a thread-fleet replay of a short trace returns, request for request,
  the responses of the reference ``Fleet`` on the same trace (routed to
  the same replicas), bit for bit.

The reference fleet runs in a process whose XLA rounds once per operation
(``--xla_cpu_max_isa=AVX``, as the port does): on a CPU with FMA, XLA
contracts the Harris window's multiply-adds, which moves its scores by an
ulp.  Tiles are 32 with halo 8, K 16; algorithm sets come from harris,
shi_tomasi and fast.  Every replica runs with ``device="cpu"``.
"""
import dataclasses
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.serve import router as jrouter
from repro_torch.configs.difet_paper import DifetConfig
from repro_torch.core import engine
from repro_torch.data.landsat import synthetic_scene
from repro_torch.serve import (Fleet, FleetConfig, HashRing, Router,
                               RouterConfig, ServeConfig, ServiceOverloaded,
                               Shed, TokenBucket, TraceConfig, make_trace,
                               scene_key, tile_pool)
from repro_torch.serve.fleet import DEAD, READY, RETIRED
from repro_torch.serve.router import (SHED_CLOSED, SHED_FLEET_SATURATED,
                                      SHED_NO_REPLICA, SHED_TENANT_THROTTLED)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

BASE = DifetConfig(tile=32, halo=8, max_keypoints_per_tile=16)
SRC = Path(__file__).resolve().parents[1] / "src"


def fleet_cfg(n, *, cache_dir=None, lease_dir=None, lease_ttl_s=5.0,
              max_batch=4, max_pending=1024, cache_entries=0,
              max_batch_delay_s=0.005, min_replicas=1, max_replicas=None,
              scale_up=16.0, scale_down=2.0, grace=3, slo_p99_s=0.5,
              router=None) -> FleetConfig:
    return FleetConfig(
        serve=ServeConfig(base=BASE, buckets=(32,), max_batch=max_batch,
                          max_batch_delay_s=max_batch_delay_s,
                          max_pending=max_pending,
                          cache_entries=cache_entries, device="cpu"),
        router=router or RouterConfig(),
        initial_replicas=n, min_replicas=min_replicas,
        max_replicas=max_replicas or max(n, 2),
        warm_algorithm_sets=(("harris",),),
        cache_dir=str(cache_dir) if cache_dir else None,
        lease_dir=str(lease_dir) if lease_dir else None,
        lease_ttl_s=lease_ttl_s, slo_p99_s=slo_p99_s,
        scale_up_queue_per_replica=scale_up,
        scale_down_queue_per_replica=scale_down,
        scale_down_grace_ticks=grace)


def direct(gray, algs=("harris",)):
    """The port's eager ``extract_features_multi`` on the bucket-padded
    tile: what every served result must equal bit for bit."""
    from repro_torch.serve.buckets import BucketTable
    table = BucketTable((32,), BASE)
    tile, header = table.pad_to_bucket(gray, 32)
    out = engine.extract_features_multi(tile[None], header[None],
                                        tuple(sorted(algs)),
                                        table.cfg_for(32), device="cpu")
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


def assert_bitwise_equal_to_reference(ours, ref):
    """Every key of the reference's result, bit for bit: floats by their
    bits (same dtype), integers and flags by value (the reference's counts
    are int32, the port's int64)."""
    assert set(ours) == set(ref)
    for k, want in ref.items():
        got = np.asarray(ours[k])
        assert got.shape == want.shape, k
        if want.dtype.kind == "f":
            assert got.dtype == want.dtype, k
            assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), k
        else:
            assert got.dtype.kind == want.dtype.kind, k
            assert np.array_equal(got, want), k


# ---- consistent hashing, token buckets, typed sheds ------------------------

def test_hash_ring_routes_as_the_reference_minimal_remap_and_balance():
    ring, jring = HashRing(vnodes=64), jrouter.HashRing(vnodes=64)
    for name in ("r1", "r2", "r3", "r4"):
        ring.add(name)
        jring.add(name)
    keys = [f"scene-{i}" for i in range(400)]
    before = {k: ring.lookup(k) for k in keys}
    assert before == {k: jring.lookup(k) for k in keys}
    share = {n: sum(1 for v in before.values() if v == n)
             for n in ring.names}
    assert all(s > 0.05 * len(keys) for s in share.values())
    ring.remove("r3")
    jring.remove("r3")
    after = {k: ring.lookup(k) for k in keys}
    assert after == {k: jring.lookup(k) for k in keys}
    for k in keys:
        if before[k] != "r3":
            assert after[k] == before[k]     # only r3's keys remapped
        else:
            assert after[k] != "r3"
    ring.add("r3")
    assert {k: ring.lookup(k) for k in keys} == before
    assert HashRing().lookup("x") is None


def test_token_bucket_throttles_and_refills():
    for cls in (TokenBucket, jrouter.TokenBucket):
        tb = cls(rate=50.0, burst=3)
        assert [tb.take()[0] for _ in range(4)] == [True, True, True, False]
    ok, retry = tb.take()
    assert not ok and retry > 0
    tb = TokenBucket(rate=50.0, burst=3)
    for _ in range(3):
        tb.take()
    ok, retry = tb.take()
    time.sleep(retry + 0.05)
    assert tb.take()[0]                   # refilled
    assert TokenBucket(float("inf"), 1).take() == (True, 0.0)


def test_router_typed_sheds_as_the_reference():
    assert (SHED_TENANT_THROTTLED, SHED_FLEET_SATURATED, SHED_NO_REPLICA,
            SHED_CLOSED) == (jrouter.SHED_TENANT_THROTTLED,
                             jrouter.SHED_FLEET_SATURATED,
                             jrouter.SHED_NO_REPLICA, jrouter.SHED_CLOSED)
    img = np.zeros((8, 8), np.float32)
    r = Router(RouterConfig(tenant_limits={"limited": (0.001, 1.0)}))
    with pytest.raises(Shed) as e:        # empty pool
        r.submit(img, ("harris",))
    assert e.value.reason == SHED_NO_REPLICA
    r._bucket("limited").take()           # burn the only token (burst=1)
    with pytest.raises(Shed) as e:
        r.submit(img, ("harris",), tenant="limited")
    assert e.value.reason == SHED_TENANT_THROTTLED
    assert e.value.tenant == "limited" and e.value.retry_after_s > 0
    assert isinstance(e.value, ServiceOverloaded)
    with pytest.raises(Shed) as e:
        Router(RouterConfig(max_global_pending=0)).submit(img, ("harris",))
    assert e.value.reason == SHED_FLEET_SATURATED
    r.close()
    with pytest.raises(Shed) as e:
        r.submit(img, ("harris",))
    assert e.value.reason == SHED_CLOSED
    s = r.stats()
    assert s["shed_total"] == sum(s["shed"].values()) == 3
    assert s["shed"] == {SHED_NO_REPLICA: 1, SHED_TENANT_THROTTLED: 1,
                         SHED_CLOSED: 1}


# ---- fleet routing + lifecycle --------------------------------------------

def test_affinity_routes_same_scene_to_the_reference_replica():
    fleet = Fleet(fleet_cfg(2, cache_entries=128))
    try:
        tile = synthetic_scene(32, 32, 42)
        for _ in range(6):
            fleet.submit(tile, ("harris",), scene_key="scene-X").result(60)
        s = fleet.stats()
        assert s["routed_affinity"] == 6 and s["routed_spill"] == 0
        jring = jrouter.HashRing(64)
        for name in fleet.ready_replicas():
            jring.add(name)
        owner = jring.lookup("scene-X")
        assert {n: r["submitted"] for n, r in s["replicas"].items()} == {
            n: (6 if n == owner else 0) for n in fleet.ready_replicas()}
    finally:
        fleet.close()


def test_drain_then_retire_drops_nothing():
    step_lock = threading.Lock()
    fleet = Fleet(fleet_cfg(2, max_batch=4), step_lock=step_lock)
    try:
        tiles = [synthetic_scene(32, 32, 600 + i) for i in range(12)]
        with step_lock:                   # keep every request in flight
            handles = [fleet.submit(t, ("harris",), scene_key=f"scene-{i}")
                       for i, t in enumerate(tiles)]
            victim = max(fleet.ready_replicas(),
                         key=lambda n: fleet.router._slots[n]
                         .service.scheduler.queue_depth)
            drainer = threading.Thread(target=fleet.drain_replica,
                                       args=(victim,))
            drainer.start()
            time.sleep(0.1)               # drain starts while work queued
        drainer.join(60)
        assert not drainer.is_alive()
        results = [h.result(60) for h in handles]   # zero dropped responses
        for t, r in zip(tiles, results):
            assert_results_equal(r.results, direct(t))
        assert fleet.replicas[victim].state == RETIRED
        assert victim not in fleet.router.replica_names()
        fleet.extract(tiles[0], ("harris",), timeout=60)
    finally:
        fleet.close()


def test_kill_replica_midflight_readmits_bit_identical():
    step_lock = threading.Lock()
    fleet = Fleet(fleet_cfg(2, max_batch=4), step_lock=step_lock)
    try:
        tiles = [synthetic_scene(32, 32, 700 + i) for i in range(10)]
        with step_lock:                   # all work pending/in flight
            handles = [fleet.submit(t, ("harris",), scene_key=f"scene-{i}")
                       for i, t in enumerate(tiles)]
            victim = max(fleet.ready_replicas(),
                         key=lambda n: fleet.router._slots[n]
                         .service.scheduler.queue_depth)
            fleet.kill_replica(victim)    # re-admission happens in here
        results = [h.result(60) for h in handles]
        for t, r in zip(tiles, results):
            assert_results_equal(r.results, direct(t))
        assert fleet.router.readmitted >= 1
        assert fleet.replicas[victim].state == DEAD
        assert victim not in fleet.router.replica_names()
    finally:
        fleet.close()


def test_stale_lease_detects_silent_crash_and_readmits(tmp_path):
    fleet = Fleet(fleet_cfg(2, lease_dir=tmp_path, lease_ttl_s=0.5,
                            max_batch=64, max_batch_delay_s=10.0))
    try:
        tile = synthetic_scene(32, 32, 801)
        h = fleet.submit(tile, ("harris",), scene_key="scene-crash")
        victim = next(iter(fleet.router._outstanding.values())).replica
        fleet.router._slots[victim].service.kill()   # the fleet is not told
        for name in fleet.ready_replicas():          # no 10 s batch wait
            fleet.replicas[name].service.scheduler.max_batch_delay_s = 0.005
        assert fleet.maintenance_tick() == []        # lease still fresh
        assert fleet.replicas[victim].state == READY
        time.sleep(0.6)                              # let the lease expire
        assert victim in fleet.maintenance_tick()
        assert fleet.replicas[victim].state == DEAD
        assert_results_equal(h.result(60).results, direct(tile))
    finally:
        fleet.close()


def test_autoscaler_scales_up_on_depth_and_down_after_grace():
    step_lock = threading.Lock()
    fleet = Fleet(fleet_cfg(1, min_replicas=1, max_replicas=2,
                            scale_up=4.0, scale_down=2.0, grace=2,
                            slo_p99_s=1e9),
                  step_lock=step_lock)
    try:
        tiles = [synthetic_scene(32, 32, 900 + i) for i in range(12)]
        with step_lock:                   # queue builds past the watermark
            handles = [fleet.submit(t, ("harris",)) for t in tiles]
            action = fleet.autoscale_tick()
        assert action.startswith("scale_up:")
        assert len(fleet.ready_replicas()) == 2
        ev = fleet.scale_events[-1]
        assert (ev["trigger"], ev["before"], ev["after"]) == \
            ("queue_depth", 1, 2)
        for t, h in zip(tiles, handles):
            assert_results_equal(h.result(60).results, direct(t))
        assert fleet.autoscale_tick() == "hold"      # grace tick 1 of 2
        action = fleet.autoscale_tick()
        assert action.startswith("scale_down:")
        assert fleet.replicas[action.split(":", 1)[1]].state == RETIRED
        assert len(fleet.ready_replicas()) == 1
        assert fleet.autoscale_tick() == "hold"      # at min_replicas
        fleet.extract(tiles[0], ("harris",), timeout=60)
    finally:
        fleet.close()


def test_concurrent_replicas_build_each_program_once():
    """Replicas of one process build their programs under one process-wide
    lock (on the card one graph captures at a time): many threads asking
    four caches for three programs each, with a short switch interval, get
    one program per (cache, key), every thread the same object."""
    from repro_torch.serve.buckets import BucketTable, CompileCache
    table = BucketTable((32,), BASE)
    caches = [CompileCache(table, 4, device="cpu") for _ in range(4)]
    keys = [("harris",), ("fast",), ("harris", "shi_tomasi")]
    got, errors = [], []

    def ask(cache):
        try:
            for algs in keys * 3:
                got.append((id(cache), algs, id(cache.get(32, algs))))
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=ask, args=(c,))
                   for c in caches for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads) and not errors
    assert [c.programs for c in caches] == [3] * 4
    built = {}
    for cache_id, algs, fn_id in got:
        built.setdefault((cache_id, algs), set()).add(fn_id)
    assert len(built) == 12 and all(len(v) == 1 for v in built.values())


def test_slo_scale_up_on_p99_breach_records_decision():
    fleet = Fleet(fleet_cfg(1, max_replicas=2, slo_p99_s=1e-4,
                            scale_up=1e9))    # any latency breaches
    try:
        for i in range(4):
            fleet.extract(synthetic_scene(32, 32, 700 + i), ("harris",),
                          timeout=60)
        assert fleet.autoscale_tick().startswith("scale_up:")
        ev = fleet.scale_events[-1]
        assert (ev["action"], ev["trigger"]) == ("scale_up", "p99_latency")
        assert (ev["before"], ev["after"]) == (1, 2)
        assert ev["value"] > ev["slo_p99_s"] == fleet.cfg.slo_p99_s
        assert fleet.stats()["scale_events"][-1] == ev
    finally:
        fleet.close()


# ---- a replay against the reference Fleet ----------------------------------

TRACE = dict(n_requests=32, seed=11, unique_scenes=6, tile_sizes=(32,),
             algorithm_sets=(("harris",), ("fast",), ("harris", "shi_tomasi")),
             tenants=("tenant-a", "tenant-b"), tenant_weights=(0.75, 0.25))
ROUTER = dict(spill_queue_threshold=1 << 30)   # affinity only: deterministic

_JAX_FLEET = """
import sys, tempfile
import numpy as np
from repro.configs.difet_paper import DifetConfig
from repro.serve import (Fleet, FleetConfig, RouterConfig, ServeConfig,
                         TraceConfig, make_trace, scene_key, tile_pool)
tcfg = TraceConfig(**{trace})
trace, pool = make_trace(tcfg), tile_pool(tcfg)
fleet = Fleet(FleetConfig(
    serve=ServeConfig(base=DifetConfig(tile=32, halo=8,
                                       max_keypoints_per_tile=16),
                      buckets=(32,), max_batch=4, max_batch_delay_s=0.005,
                      cache_entries=128),
    router=RouterConfig(**{router}), initial_replicas=2,
    warm_algorithm_sets=(), cache_dir=tempfile.mkdtemp()))
handles = [fleet.submit(pool[ev.pool_key], ev.algorithms, tenant=ev.tenant,
                        scene_key=scene_key(ev)) for ev in trace]
out = {{}}
for i, h in enumerate(handles):
    for alg, res in h.result(300).results.items():
        for k, v in res.items():
            out[f"{{i}}/{{alg}}/{{k}}"] = np.asarray(v)
s = fleet.stats()
for name, r in s["replicas"].items():
    out[f"submitted/{{name}}"] = np.asarray(r["submitted"])
fleet.close()
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_fleet(tmp_path_factory):
    """The reference ``Fleet``'s responses to the trace, from a process
    whose XLA rounds once per operation."""
    path = tmp_path_factory.mktemp("jax_fleet") / "fleet.npz"
    code = _JAX_FLEET.format(trace=TRACE, router=ROUTER)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_max_isa=AVX", PYTHONPATH=str(SRC))
    done = subprocess.run([sys.executable, "-c", code, str(path)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_fleet_replay_equals_the_reference_fleet(jax_fleet, tmp_path):
    """The same trace through a two-replica thread fleet of each package
    (shared disk tier, result cache on): every response bit for bit the
    reference's, each request served by the replica the reference's
    router chose, and every response the port's direct result."""
    tcfg = TraceConfig(**TRACE)
    trace, pool = make_trace(tcfg), tile_pool(tcfg)
    fleet = Fleet(dataclasses.replace(
        fleet_cfg(2, cache_entries=128, cache_dir=tmp_path),
        router=RouterConfig(**ROUTER), warm_algorithm_sets=()))
    try:
        handles = [fleet.submit(pool[ev.pool_key], ev.algorithms,
                                tenant=ev.tenant, scene_key=scene_key(ev))
                   for ev in trace]
        responses = [h.result(60) for h in handles]
        s = fleet.stats()
    finally:
        fleet.close()
    assert s["submitted"] == len(trace) and s["outstanding"] == 0
    assert s["routed_spill"] == 0 and s["readmitted"] == 0
    assert {n: r["submitted"] for n, r in s["replicas"].items()} == {
        k.split("/", 1)[1]: int(v) for k, v in jax_fleet.items()
        if k.startswith("submitted/")}
    oracle = {}
    for i, (ev, resp) in enumerate(zip(trace, responses)):
        assert resp.algorithms == ev.algorithms
        key = (ev.pool_key, ev.algorithms)
        if key not in oracle:
            oracle[key] = direct(pool[ev.pool_key], ev.algorithms)
        assert_results_equal(resp.results, oracle[key])
        for alg in ev.algorithms:
            prefix = f"{i}/{alg}/"
            want = {k[len(prefix):]: v for k, v in jax_fleet.items()
                    if k.startswith(prefix)}
            assert_bitwise_equal_to_reference(resp.results[alg], want)
