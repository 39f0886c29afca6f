"""The port's process replicas (``repro_torch.serve.{proc,transport,chaos}``)
on the CPU: the cases of ``tests/test_proc_fleet.py`` against the port,
held to the JAX package where the two meet.

* The wire: a message (and a mailbox request or response) written by
  ``repro.serve.transport`` decodes in the port and the reverse, meta
  equal and arrays bit for bit; a chaos plan written by either is read
  by the other.
* The worker: its config crosses the wire with ``device`` and
  ``use_kernels``; a worker for the card on a host without one raises
  before it is ready (no quiet CPU fallback); a CPU worker's responses
  equal the JAX ``FeatureService``'s bit for bit.
* The fleet of three CPU workers: a raw ``kill -9`` found only through the
  stale lease, with every accepted request re-admitted bit for bit; a
  live worker whose heartbeat stalls declared dead and reaped; the last
  survivor drains cleanly.
* The shared disk tier: a partitioned directory degrades to compute, torn
  writes read as misses.

The JAX service runs in a process whose XLA rounds once per operation
(``--xla_cpu_max_isa=AVX``, as the port does).  Workers inherit
``OMP_NUM_THREADS=1``.  Tiles are 32 with halo 8, K 16.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.serve import chaos as jchaos
from repro.serve import transport as jtransport
from repro_torch.configs.difet_paper import DifetConfig
from repro_torch.core import engine
from repro_torch.data.landsat import synthetic_scene
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serve import (DiskCacheTier, FeatureService, Fleet,
                               FleetConfig, ProcReplicaClient, ServeConfig,
                               WorkerMailbox)
from repro_torch.serve import transport as ptransport
from repro_torch.serve.chaos import (ChaosPlan, cache_partition, clear_plan,
                                     read_plan, tear_file, write_plan)
from repro_torch.serve.fleet import DEAD, RETIRED
from repro_torch.serve.proc import (serve_config_from_json,
                                    serve_config_to_json)
from repro_torch.serve.transport import decode_message, encode_message

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

BASE = DifetConfig(tile=32, halo=8, max_keypoints_per_tile=16)
SRC = Path(__file__).resolve().parents[1] / "src"
ALGS = ("harris", "shi_tomasi", "fast")
PARITY_SEEDS = tuple(range(100, 104))
KILL_SEEDS = tuple(range(500, 508))


def serve_cfg(**kw) -> ServeConfig:
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_batch_delay_s", 0.005)
    kw.setdefault("cache_entries", 64)
    kw.setdefault("device", "cpu")
    return ServeConfig(base=BASE, buckets=(32,), **kw)


def direct(gray, algs=ALGS):
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
    """Floats by their bits, integers and flags by value (the reference's
    counts are int32, the port's int64)."""
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


def wait_until(pred, timeout=30.0, interval=0.02, desc="condition"):
    deadline = time.monotonic() + timeout
    while True:
        val = pred()
        if val:
            return val
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout}s waiting for "
                                 f"{desc}")
        time.sleep(interval)


# ---- the wire, both ways ---------------------------------------------------

ARRAYS = {"image": np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
          "count": np.array(7, np.int32),                  # 0-d leaf
          "total": np.array(-3, np.int64),
          "mask": np.array([True, False]),
          "bits": np.array([0xDEADBEEF, 1], np.uint32),
          "empty": np.zeros((0, 5), np.float32)}
META = {"request_id": "r1", "algorithms": ["harris", "fast"],
        "trace_id": "t9", "timing": {"completed_at": 1.5, "sizes": [4, 2]}}


@pytest.mark.parametrize("writer,reader", [
    (jtransport, ptransport), (ptransport, jtransport)],
    ids=["reference-to-port", "port-to-reference"])
def test_message_crosses_between_the_packages(tmp_path, writer, reader):
    path = tmp_path / "m.npz"
    writer.write_message(path, META, ARRAYS)
    assert not list(tmp_path.glob("*.tmp.*"))          # tmp committed away
    meta, got = reader.read_message(path)
    assert meta == META and set(got) == set(ARRAYS)
    for k, want in ARRAYS.items():
        assert got[k].dtype == want.dtype and got[k].shape == want.shape, k
        assert got[k].tobytes() == want.tobytes(), k
        assert not got[k].flags.writeable
    assert encode_message(META, ARRAYS) == \
        jtransport.encode_message(META, ARRAYS)
    assert decode_message(jtransport.encode_message(META))[0] == META
    with pytest.raises(ValueError):                    # reserved slot
        encode_message({}, {"__meta__": np.zeros(1)})


def test_mailboxes_of_the_two_packages_talk(tmp_path):
    """A request the reference's router side sends is claimed by the
    port's worker side; the port's response and telemetry read back on
    the reference's side (and its pending inventory agrees)."""
    ref, ours = (jtransport.WorkerMailbox(tmp_path),
                 WorkerMailbox(tmp_path))
    img = synthetic_scene(32, 32, 3)
    for rid in ("r1", "r2"):
        ref.send_request(rid, {"algorithms": ["harris"]}, {"image": img})
    claimed = ours.claim_requests()
    assert [rid for rid, _, _ in claimed] == ["r1", "r2"]
    assert np.array_equal(claimed[0][2]["image"], img)
    ours.send_response("r1", {"status": "ok", "request_id": "r1"},
                       {"harris/total_count": np.array(5, np.int64)})
    meta, arrays = ref.try_read_response("r1")
    assert meta["status"] == "ok"
    assert arrays["harris/total_count"].dtype == np.int64
    assert ref.pending_requests() == ours.pending_requests() == ["r2"]
    ours.publish_telemetry("w1", 1, {"seq": 1, "worker": "w1"})
    assert ref.collect_telemetry() == [{"seq": 1, "worker": "w1"}]


def test_torn_request_is_quarantined_never_delivered(tmp_path):
    mbox = WorkerMailbox(tmp_path)
    mbox.send_request("r1", {"algorithms": ["harris"]},
                      {"image": np.zeros((32, 32), np.float32)})
    tear_file(mbox.req / "r1.npz", keep=40)            # torn-write fault
    assert mbox.claim_requests() == []                 # skipped, not served
    assert list(mbox.work.glob("*.corrupt"))           # quarantined
    assert mbox.pending_requests() == []               # never re-admitted
    mbox.send_request("r2", {"algorithms": ["harris"]},
                      {"image": np.zeros((32, 32), np.float32)})
    assert [rid for rid, _, _ in mbox.claim_requests()] == ["r2"]


def test_claimed_but_unanswered_is_enumerable_for_readmission(tmp_path):
    mbox = WorkerMailbox(tmp_path)
    img = np.zeros((8, 8), np.float32)
    for rid in ("r1", "r2", "r3"):
        mbox.send_request(rid, {"algorithms": ["harris"]}, {"image": img})
    assert [r for r, _, _ in mbox.claim_requests()] == ["r1", "r2", "r3"]
    mbox.send_response("r2", {"status": "ok", "request_id": "r2"}, {})
    assert mbox.pending_requests() == ["r1", "r3"]
    assert mbox.has_response("r2") and not (mbox.work / "r2.npz").exists()
    assert mbox.try_read_response("r2")[0]["status"] == "ok"


@pytest.mark.parametrize("device", [None, "cpu"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_serve_config_wire_roundtrip(device, use_kernels):
    cfg = serve_cfg(max_pending=99, device=device, use_kernels=use_kernels,
                    cache_dir="/x/y")
    wire = json.loads(json.dumps(serve_config_to_json(cfg)))
    assert wire["device"] == device and wire["use_kernels"] == use_kernels
    back = serve_config_from_json(wire)
    assert back == cfg and isinstance(back.base.scene_hw, tuple)


def test_chaos_plans_cross_between_the_packages(tmp_path):
    assert read_plan(tmp_path) == ChaosPlan()          # absent: all off
    jchaos.write_plan(tmp_path, jchaos.ChaosPlan(heartbeat_stall_s=2.0,
                                                 exit_after_requests=3))
    plan = read_plan(tmp_path)
    assert (plan.heartbeat_stall_s, plan.exit_after_requests) == (2.0, 3)
    assert plan.plan_time > 0                          # stamped from mtime
    assert plan.heartbeat_stalled(plan.plan_time + 1.0)
    assert not plan.heartbeat_stalled(plan.plan_time + 3.0)
    assert not plan.responses_held(plan.plan_time)
    write_plan(tmp_path, ChaosPlan(hold_responses_s=4.0))
    assert jchaos.read_plan(tmp_path).hold_responses_s == 4.0
    (tmp_path / "chaos.json").write_text("{not json")  # torn plan write
    assert read_plan(tmp_path) == ChaosPlan()          # never faults a worker
    clear_plan(tmp_path)
    assert read_plan(tmp_path) == ChaosPlan()


# ---- workers ---------------------------------------------------------------

def test_worker_for_the_card_without_one_raises_before_ready(tmp_path,
                                                             monkeypatch):
    """``device=None`` means the card: on a host without CUDA the worker
    raises before it publishes its ready marker, and ``wait_ready``
    reports its log — it never serves from the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA, so the worker would be ready")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    client = ProcReplicaClient.spawn(
        "w0", tmp_path / "mbox" / "w0",
        serve_cfg(device=None, use_kernels=False), tmp_path / "leases")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        client.wait_ready(120.0)
    assert client.proc.returncode != 0
    assert client.mailbox.read_ready() is None


_JAX_SERVICE = """
import sys
import numpy as np
from repro.configs.difet_paper import DifetConfig
from repro.data.landsat import synthetic_scene
from repro.serve import FeatureService, ServeConfig
svc = FeatureService(ServeConfig(
    base=DifetConfig(tile=32, halo=8, max_keypoints_per_tile=16),
    buckets=(32,), max_batch=4, cache_entries=0))
out = {{}}
for s in {seeds}:
    res = svc.submit(synthetic_scene(32, 32, s), {algs}).result(300).results
    for alg, r in res.items():
        for k, v in r.items():
            out[f"{{s}}/{{alg}}/{{k}}"] = np.asarray(v)
svc.close()
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    """The reference ``FeatureService``'s results for the parity and kill
    tiles, from a process whose XLA rounds once per operation."""
    path = tmp_path_factory.mktemp("jax_service") / "served.npz"
    code = _JAX_SERVICE.format(seeds=PARITY_SEEDS + KILL_SEEDS, algs=ALGS)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_cpu_max_isa=AVX", PYTHONPATH=str(SRC))
    done = subprocess.run([sys.executable, "-c", code, str(path)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-4000:]
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def assert_equals_jax(results, jax_results, seed):
    for alg in ALGS:
        prefix = f"{seed}/{alg}/"
        want = {k[len(prefix):]: v for k, v in jax_results.items()
                if k.startswith(prefix)}
        assert_bitwise_equal_to_reference(results[alg], want)


@pytest.fixture(scope="module")
def proc_fleet(tmp_path_factory):
    """Three CPU worker processes behind one router (spawned at once),
    shared by the tests below in file order: replica parity, a kill -9,
    a heartbeat stall, the survivor's drain."""
    tmp = tmp_path_factory.mktemp("proc_fleet")
    cfg = FleetConfig(
        serve=serve_cfg(), initial_replicas=3, min_replicas=1,
        max_replicas=3, warm_algorithm_sets=(tuple(sorted(ALGS)),),
        cache_dir=str(tmp / "cache"), lease_dir=str(tmp / "leases"),
        transport_dir=str(tmp / "mbox"), proc=True, lease_ttl_s=0.6,
        heartbeat_interval_s=0.1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        fleet = Fleet(cfg)
    yield fleet
    fleet.close()


def test_worker_parity_against_the_jax_service(proc_fleet, jax_results):
    """One worker, addressed directly: a registered scene id and raw
    arrays both come back bit for bit the JAX service's results (and the
    port's direct ones); its ready marker names the CPU, no kernel
    captured and no card memory."""
    name = sorted(proc_fleet.ready_replicas())[0]
    client = proc_fleet.replicas[name].service
    info = client.mailbox.read_ready()
    assert info["device"] == "cpu" and info["programs"] == 1
    assert info["memory_reserved"] == 0
    assert set(info["kernels_captured"].values()) == {0}
    tiles = {s: synthetic_scene(32, 32, s) for s in PARITY_SEEDS}
    client.register_scene("scene-a", tiles[PARITY_SEEDS[0]])
    handles = [client.submit("scene-a", ALGS)]
    handles += [client.submit(tiles[s], ALGS) for s in PARITY_SEEDS[1:]]
    for s, h in zip(PARITY_SEEDS, handles):
        resp = h.result(60)
        assert resp.algorithms == ALGS
        assert_results_equal(resp.results, direct(tiles[s]))
        assert_equals_jax(resp.results, jax_results, s)
    s = client.stats()
    assert s["alive"] and s["pid"] == client.pid and s["queue_depth"] == 0


def test_sigkill_found_by_stale_lease_readmits_bit_identical(proc_fleet,
                                                             jax_results):
    """A raw ``kill -9`` on a replica holding outstanding work: the parent
    learns of it only through the stale lease, the victim's requests go
    to the survivors, and every accepted request completes bit for bit
    as the JAX service computes it."""
    fleet = proc_fleet
    m0 = obs_metrics.registry().snapshot()
    for name in fleet.ready_replicas():                # keep work outstanding
        write_plan(fleet.transport_dir / name, ChaosPlan(hold_responses_s=30))
    tiles = {s: synthetic_scene(32, 32, s) for s in KILL_SEEDS}
    handles = [fleet.submit(tiles[s], ALGS, scene_key=f"scene-{s}")
               for s in KILL_SEEDS]
    victim = next(iter(fleet.router._outstanding.values())).replica
    fleet.sigkill_replica(victim)                      # no cooperative path
    for name in fleet.ready_replicas():
        clear_plan(fleet.transport_dir / name)

    def detected():
        fleet.maintenance_tick()
        return fleet.replicas[victim].state == DEAD
    wait_until(detected, 20, desc="stale-lease death detection")
    assert victim not in fleet.router.replica_names()
    for s, h in zip(KILL_SEEDS, handles):              # zero accepted lost
        resp = h.result(90)
        assert_results_equal(resp.results, direct(tiles[s]))
        assert_equals_jax(resp.results, jax_results, s)
    m1 = obs_metrics.registry().snapshot()
    assert (m1.get("difet.fleet.stale_lease_deaths", 0)
            - m0.get("difet.fleet.stale_lease_deaths", 0)) >= 1
    assert fleet.router.readmitted >= 1


def test_heartbeat_stall_live_worker_declared_dead_and_reaped(proc_fleet):
    """A live worker that stops refreshing its lease is, to the control
    plane, a hung one: declared dead, its process reaped, and the fleet
    keeps serving from the survivor."""
    fleet = proc_fleet
    live = sorted(fleet.ready_replicas())
    assert len(live) == 2, live
    victim = live[0]
    client = fleet.replicas[victim].service
    assert client.alive()
    write_plan(fleet.transport_dir / victim, ChaosPlan(heartbeat_stall_s=60))

    def detected():
        fleet.maintenance_tick()
        return fleet.replicas[victim].state == DEAD
    wait_until(detected, 20, desc="stale lease on a live process")
    wait_until(lambda: not client.alive(), 10, desc="zombie reaped")
    assert victim not in fleet.router.replica_names()
    tile = synthetic_scene(32, 32, 601)
    assert_results_equal(
        fleet.extract(tile, ALGS, timeout=60).results, direct(tile))


def test_survivor_drains_cleanly(proc_fleet):
    fleet = proc_fleet
    [survivor] = fleet.ready_replicas()
    client = fleet.replicas[survivor].service
    tiles = [synthetic_scene(32, 32, 620 + i) for i in range(4)]
    handles = [fleet.submit(t, ("harris",)) for t in tiles]
    fleet.drain_replica(survivor)                      # with work queued
    assert client.proc.returncode == 0                 # clean exit
    assert fleet.replicas[survivor].state == RETIRED
    for t, h in zip(tiles, handles):                   # zero dropped
        assert_results_equal(h.result(10).results, direct(t, ("harris",)))


# ---- the shared disk tier under faults -------------------------------------

def test_cache_partition_degrades_to_compute(tmp_path):
    root = tmp_path / "tier"
    tier = DiskCacheTier(root)
    key = ("digest", "harris", "cfg")
    val = {"x": np.ones((3,), np.float32)}
    with cache_partition(root):
        tier.put(key, val)                             # absorbed, no raise
        assert tier.get(key) is None                   # miss, no raise
    assert tier.errors >= 1 and tier.stats()["errors"] >= 1
    tier.put(key, val)                                 # partition healed
    assert np.array_equal(tier.get(key)["x"], val["x"])
    # a service on the partitioned tier recomputes: same bits as direct
    svc = FeatureService(dataclasses.replace(serve_cfg(),
                                             cache_dir=str(root)))
    try:
        tile = synthetic_scene(32, 32, 640)
        with cache_partition(root):
            got = svc.extract(tile, ("harris",), timeout=60).results
        assert_results_equal(got, direct(tile, ("harris",)))
        assert svc.cache.disk.stats()["errors"] >= 1
    finally:
        svc.close()


def test_torn_cache_writes_read_as_miss(tmp_path):
    tier = DiskCacheTier(tmp_path)
    key = ("digest-torn", "harris", "cfg")
    path = tier.path_for(key)
    path.parent.mkdir(parents=True, exist_ok=True)
    (path.with_suffix(".tmp.99999.1")).write_bytes(b"partial dead write")
    assert tier.get(key) is None                       # dead writer's tmp
    tier.put(key, {"x": np.arange(64, dtype=np.float32)})
    tear_file(path, keep=48)                           # committed, then torn
    assert tier.get(key) is None
    assert not path.exists()                           # torn entry dropped
    tier.put(key, {"x": np.arange(64, dtype=np.float32)})
    assert np.array_equal(tier.get(key)["x"],
                          np.arange(64, dtype=np.float32))
