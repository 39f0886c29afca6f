"""Replica pool + autoscaler: N ``FeatureService`` replicas behind one
:class:`serve/router.py::Router`.

Port of ``repro/serve/fleet.py``: the fleet a load balancer would
replicate.  On the card every replica serves from CUDA graphs on a
stream of its own (`serve/buckets.py::CompileCache`), so a replica that
captures its graphs while the others replay (a scale-up under traffic)
meets none of their work.  Replicas come in two kinds:

* **thread** (default): an in-process `serve/api.py::FeatureService`
  (its own continuous-batching scheduler, compile cache, local result
  LRU) — cheap, shares the heap, the unit-test and benchmark workhorse.
* **process** (``FleetConfig.proc=True``): a `serve/proc.py` worker
  spawned as an OS process, driven through the spooled-file transport
  (`serve/transport.py`).  Nothing is shared but what a distributed
  worker would actually share: the on-disk result tier
  (`serve/cache.py::DiskCacheTier`), `LeaseBoard` lease files, and the
  mailbox directory.  ``kill -9`` is a real SIGKILL.  On one card the
  workers' CUDA contexts time-slice it.

Replica lifecycle::

    SPAWNING → WARMING → READY → DRAINING → RETIRED
                   │        │
                   │        └─ kill / stale lease → DEAD (chaos path)
                   └─ warm-up builds every (bucket, algorithm-set)
                      program (captures its graph on the card) before the
                      replica joins the ring — a new replica never serves
                      a capture stall to traffic.

Liveness rides `core/job.py::LeaseBoard` leases under each replica's
name.  Thread replicas are heartbeaten by the fleet's maintenance tick
*only while their runner thread is alive*; process replicas heartbeat
**themselves** — the parent never refreshes a worker's lease, so a
SIGKILL stops the heartbeat at the same instant it stops the work and
the next maintenance tick past the TTL declares the replica DEAD and
re-admits its outstanding requests through `Router.readmit`
(bit-identically — extraction is deterministic).

Autoscaling is SLO-driven: the controller reads the windowed p99 of
``difet.fleet.request_latency_s`` (admission → work completion, the
histogram `serve/router.py` feeds) between ticks and scales **up** when
it breaches ``slo_p99_s``; fleet queue depth per replica is kept as a
fast-path up-trigger (a saturated queue predicts the breach before
enough completions exist to measure it).  Scale **down** only happens
when the window's p99 is comfortably under the SLO *and* queues are
shallow for ``scale_down_grace_ticks`` consecutive ticks, and only by
*draining*: the replica leaves the ring, finishes its queue, retires
with zero dropped responses.  Every decision is recorded in
``Fleet.scale_events`` (trigger metric, value, before/after replica
count), which `Fleet.stats` returns.
"""
from __future__ import annotations

import dataclasses
import tempfile
import threading
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.job import LeaseBoard
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.agg import TelemetryAggregator
from repro_torch.obs.slo import BurnRateMonitor, SloPolicy
from repro_torch.serve import chaos
from repro_torch.serve.api import FeatureService, ServeConfig
from repro_torch.serve.proc import ProcReplicaClient
from repro_torch.serve.router import Router, RouterConfig

__all__ = ["FleetConfig", "Fleet", "Replica",
           "SPAWNING", "WARMING", "READY", "DRAINING", "RETIRED", "DEAD"]

# replica lifecycle states
SPAWNING = "spawning"
WARMING = "warming"
READY = "ready"
DRAINING = "draining"
RETIRED = "retired"
DEAD = "dead"


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Fleet knobs.  ``serve`` configures every replica (its
    ``cache_dir`` is overridden with the fleet's shared ``cache_dir``
    when set); ``router`` configures admission + routing.

    ``proc=True`` spawns replicas as OS processes (`serve/proc.py`)
    with mailboxes under ``transport_dir``; workers heartbeat their own
    leases every ``heartbeat_interval_s``.  ``lease_ttl_s`` bounds
    crash-detection latency: a replica that stops heartbeating is
    declared DEAD once its lease is this stale.

    SLO autoscaling: scale up when the windowed p99 of
    ``difet.fleet.request_latency_s`` exceeds ``slo_p99_s`` (or, fast
    path, when fleet queue depth per READY replica exceeds
    ``scale_up_queue_per_replica``); scale down — by draining — after
    ``scale_down_grace_ticks`` consecutive ticks with p99 below
    ``slo_p99_s * slo_scale_down_factor`` (an empty window counts as
    satisfied) and queues below ``scale_down_queue_per_replica``."""
    serve: ServeConfig = ServeConfig()
    router: RouterConfig = RouterConfig()
    initial_replicas: int = 2
    min_replicas: int = 1
    max_replicas: int = 8
    warm_algorithm_sets: Tuple[Tuple[str, ...], ...] = (("harris",),)
    cache_dir: Optional[str] = None       # shared result tier (all replicas)
    lease_dir: Optional[str] = None       # liveness leases (temp dir default)
    lease_ttl_s: float = 5.0
    # process-mode knobs
    proc: bool = False
    transport_dir: Optional[str] = None   # worker mailboxes (temp dir default)
    heartbeat_interval_s: float = 0.2
    worker_ready_timeout_s: float = 180.0
    # fleet telemetry plane (proc mode only): workers ship metric deltas
    # + span batches every interval (obs/ship.py), the parent
    # merges them into difet.fleet.* (obs/agg.py) and runs the SLO
    # burn-rate monitor over the aggregate (obs/slo.py)
    telemetry: bool = False
    telemetry_interval_s: float = 0.25
    # SLO autoscaler policy
    slo_p99_s: float = 0.5
    slo_scale_down_factor: float = 0.5
    scale_up_queue_per_replica: float = 16.0
    scale_down_queue_per_replica: float = 2.0
    scale_down_grace_ticks: int = 3
    autoscale_interval_s: float = 0.5


class Replica:
    """One pool member: the service (or process-replica client) plus its
    lifecycle state and kind (``"thread"`` | ``"proc"``)."""

    def __init__(self, name: str, service, kind: str = "thread"):
        self.name = name
        self.service = service
        self.kind = kind
        self.state = SPAWNING

    def runner_alive(self) -> bool:
        """Is the replica's execution vehicle still running — the
        scheduler runner thread (thread kind) or the worker process
        (proc kind)?  Thread replicas are heartbeaten by the fleet only
        while this holds; proc replicas heartbeat themselves, so for
        them this is zombie-reaping ground truth, not liveness."""
        if self.kind == "proc":
            return self.service.alive()
        return self.service.scheduler._thread.is_alive()


class Fleet:
    """The replica pool (see module docstring).  ``fleet.router`` is the
    client-facing submit surface; the fleet itself manages membership.

    ``scale_events`` is the audit log of every autoscale decision:
    ``{"action", "trigger", "value", "slo_p99_s", "before", "after"}``
    dicts in decision order (bounded)."""

    MAX_SCALE_EVENTS = 256

    def __init__(self, cfg: Optional[FleetConfig] = None, *,
                 step_lock: Optional[threading.Lock] = None):
        self.cfg = cfg or FleetConfig()
        self.router = Router(self.cfg.router)
        lease_dir = self.cfg.lease_dir or tempfile.mkdtemp(
            prefix="difet-fleet-leases-")
        self.lease_dir = Path(lease_dir)
        self.leases = LeaseBoard(lease_dir, ttl_s=self.cfg.lease_ttl_s)
        self.transport_dir = Path(
            self.cfg.transport_dir or tempfile.mkdtemp(
                prefix="difet-fleet-mbox-")) if self.cfg.proc else None
        self._step_lock = step_lock
        self._lock = threading.RLock()
        self.replicas: Dict[str, Replica] = {}
        self.scale_events: List[Dict[str, object]] = []
        self._counter = 0
        self._idle_ticks = 0
        self._scenes: Dict[str, object] = {}
        self._autoscaler: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # fleet lifecycle counters + pool-size gauge (difet.fleet.*)
        _reg = obs_metrics.registry()
        self._m_scale_up = _reg.counter("difet.fleet.scale_up")
        self._m_scale_down = _reg.counter("difet.fleet.scale_down")
        self._m_dead = _reg.counter("difet.fleet.replicas_dead")
        self._m_stale = _reg.counter("difet.fleet.stale_lease_deaths")
        self._g_ready = _reg.gauge("difet.fleet.ready_replicas")
        # SLO controller state: windowed p99 over the router-fed
        # admission→completion histogram, baselined each tick
        self._lat_hist = _reg.histogram("difet.fleet.request_latency_s")
        self._lat_baseline = self._lat_hist.counts()
        # fleet telemetry plane: aggregator + SLO burn-rate monitor over
        # the *aggregated* latency histogram and typed shed counters —
        # the autoscaler's p99 becomes fleet-wide, not parent-only
        self.telemetry: Optional[TelemetryAggregator] = None
        self.slo_monitor: Optional[BurnRateMonitor] = None
        if self.cfg.proc and self.cfg.telemetry:
            self.telemetry = TelemetryAggregator(_reg)
            self.slo_monitor = BurnRateMonitor(
                self._lat_hist,
                shed_counters=self._shed_counters,
                policy=SloPolicy(latency_slo_s=self.cfg.slo_p99_s))
        if self.cfg.proc:
            # parallel spawn: launch every worker first (they warm
            # concurrently — torch import + graph capture dominates),
            # then wait
            reps = [self._launch_proc()
                    for _ in range(self.cfg.initial_replicas)]
            for rep in reps:
                self._finalize_proc(rep)
        else:
            for _ in range(self.cfg.initial_replicas):
                self.spawn_replica()

    # ---- lifecycle ----------------------------------------------------------
    def _serve_cfg(self) -> ServeConfig:
        if self.cfg.cache_dir:
            return dataclasses.replace(self.cfg.serve,
                                       cache_dir=self.cfg.cache_dir)
        return self.cfg.serve

    def _launch_proc(self) -> Replica:
        with self._lock:
            self._counter += 1
            name = f"replica-{self._counter}"
            client = ProcReplicaClient.spawn(
                name, self.transport_dir / name, self._serve_cfg(),
                self.lease_dir,
                lease_ttl_s=self.cfg.lease_ttl_s,
                heartbeat_interval_s=self.cfg.heartbeat_interval_s,
                warm_algorithm_sets=self.cfg.warm_algorithm_sets,
                telemetry_interval_s=(self.cfg.telemetry_interval_s
                                      if self.cfg.telemetry else 0.0))
            rep = Replica(name, client, kind="proc")
            self.replicas[name] = rep
        rep.state = WARMING
        return rep

    def _finalize_proc(self, rep: Replica) -> str:
        rep.service.wait_ready(self.cfg.worker_ready_timeout_s)
        for scene_name, image in self._scenes.items():
            rep.service.register_scene(scene_name, image)
        rep.state = READY
        self.router.add_replica(rep.name, rep.service)
        self._g_ready.set(len(self.ready_replicas()))
        return rep.name

    def spawn_replica(self) -> str:
        """SPAWNING → WARMING → READY: build a service (or launch a
        worker process), build its programs, establish its
        liveness lease, join the ring.  Returns the replica name
        (``replica-N``)."""
        if self.cfg.proc:
            return self._finalize_proc(self._launch_proc())
        with self._lock:
            self._counter += 1
            name = f"replica-{self._counter}"
            svc = FeatureService(self._serve_cfg(), name=name,
                                 step_lock=self._step_lock)
            rep = Replica(name, svc)
            self.replicas[name] = rep
        rep.state = WARMING
        svc.warmup(self.cfg.warm_algorithm_sets)
        for scene_name, image in self._scenes.items():
            svc.register_scene(scene_name, image)
        self.leases.acquire(name, name)
        rep.state = READY
        self.router.add_replica(name, svc)
        self._g_ready.set(len(self.ready_replicas()))
        return name

    def drain_replica(self, name: str, timeout: float = 60.0) -> None:
        """READY → DRAINING → RETIRED: leave the ring, finish every queued
        item (zero dropped responses — tested), release the lease."""
        with self._lock:
            rep = self.replicas.get(name)
            if rep is None or rep.state not in (READY, DRAINING):
                return
            rep.state = DRAINING
        self.router.set_accepting(name, False)
        rep.service.drain(timeout)
        self.poll_telemetry()     # the worker's retire flush, if any
        self.router.remove_replica(name)
        self.leases.release(name, name)
        rep.state = RETIRED
        self._g_ready.set(len(self.ready_replicas()))

    def kill_replica(self, name: str) -> int:
        """Chaos: crash a replica mid-flight (thread: fail its futures;
        proc: real SIGKILL).  Its in-flight work is immediately
        re-admitted to the survivors; returns the router's cumulative
        re-admission count."""
        with self._lock:
            rep = self.replicas.get(name)
            if rep is None or rep.state in (RETIRED, DEAD):
                return 0
            rep.state = DEAD
        rep.service.kill()
        self.leases.release(name, name)
        self.router.remove_replica(name, died=True)
        self._m_dead.inc()
        self._g_ready.set(len(self.ready_replicas()))
        if self.telemetry is not None:
            self.telemetry.record_event("replica_died", replica=name,
                                        cause="kill")
        return self.router.readmitted

    def sigkill_replica(self, name: str) -> int:
        """Chaos, the *uncooperative* variant for process replicas: raw
        ``kill -9`` to the worker pid and nothing else — no state change,
        no router removal, no lease release.  Detection is entirely the
        maintenance tick's job (stale lease after ``lease_ttl_s``), which
        is the path a real worker crash takes.  Returns the pid killed."""
        with self._lock:
            rep = self.replicas.get(name)
        if rep is None or rep.kind != "proc":
            raise ValueError(f"{name} is not a process replica")
        pid = rep.service.pid
        chaos.sigkill(pid)
        return pid

    # ---- fleet telemetry ----------------------------------------------------
    def _shed_counters(self):
        reg = obs_metrics.registry()
        return [m for name, m in reg.metrics().items()
                if name.startswith("difet.router.shed.")
                and isinstance(m, obs_metrics.Counter)]

    def poll_telemetry(self) -> int:
        """Drain every worker mailbox's ``telemetry/`` channel into the
        aggregator (`obs/agg.py`); returns shipments applied.
        No-op (0) when the telemetry plane is off."""
        if self.telemetry is None:
            return 0
        for ev in self.router.drain_events():
            self.telemetry.record_event(**ev)
        with self._lock:
            reps = [r for r in self.replicas.values() if r.kind == "proc"]
        applied = 0
        for rep in reps:
            payloads = rep.service.mailbox.collect_telemetry()
            if payloads:
                applied += self.telemetry.ingest(payloads)
        return applied

    # ---- liveness + autoscaling ---------------------------------------------
    def ready_replicas(self) -> Tuple[str, ...]:
        """Names of replicas currently in the READY state."""
        with self._lock:
            return tuple(n for n, r in self.replicas.items()
                         if r.state == READY)

    def maintenance_tick(self) -> Sequence[str]:
        """Liveness pass.  Thread replicas: heartbeat their lease while
        the runner thread lives; declare DEAD when the runner died *and*
        the lease went stale.  Process replicas: never heartbeaten here
        (the worker refreshes its own lease), so a stale lease alone —
        SIGKILL, hung worker, stalled heartbeat — declares them DEAD,
        reaps any zombie process, and re-admits their outstanding work.
        Returns the names declared dead this tick."""
        self.poll_telemetry()
        died = []
        with self._lock:
            candidates = [(n, r) for n, r in self.replicas.items()
                          if r.state in (READY, DRAINING)]
        for name, rep in candidates:
            if rep.kind == "proc":
                if self.leases.fresh(name):
                    continue
                with self._lock:
                    if rep.state == DEAD:
                        continue
                    rep.state = DEAD
                rep.service.mark_dead()
                if rep.service.alive():
                    chaos.sigkill(rep.service.pid)   # reap the zombie
                self.router.remove_replica(name, died=True)
                self.leases.release(name, name)
                self._m_dead.inc()
                self._m_stale.inc()
                if self.telemetry is not None:
                    self.telemetry.record_event(
                        "replica_died", replica=name, cause="stale_lease")
                died.append(name)
            elif rep.runner_alive():
                self.leases.acquire(name, name)      # refresh own lease
            elif not self.leases.fresh(name):
                with self._lock:
                    if rep.state == DEAD:
                        continue
                    rep.state = DEAD
                self.router.remove_replica(name, died=True)
                self.leases.release(name, name)
                self._m_dead.inc()
                died.append(name)
        if died:
            self._g_ready.set(len(self.ready_replicas()))
        return died

    def _record_scale(self, action: str, trigger: str, value: float,
                      before: int, after: int) -> None:
        event = {"action": action, "trigger": trigger,
                 "value": float(value), "slo_p99_s": self.cfg.slo_p99_s,
                 "before": int(before), "after": int(after),
                 "t": time.time()}
        with self._lock:
            self.scale_events.append(event)
            del self.scale_events[:-self.MAX_SCALE_EVENTS]
        obs_metrics.registry().counter(
            f"difet.fleet.{action}.{trigger}").inc()

    def autoscale_tick(self) -> str:
        """One SLO-controller decision (pure policy — the background
        loop and the tests both call this).  Reads the windowed p99 of
        admission→completion latency since the previous tick (harvesting
        done-but-uncollected requests first so open-loop clients count),
        plus queue depth as the fast-path up-trigger.  Returns the action
        taken: ``"scale_up:<name>"``, ``"scale_down:<name>"``, or
        ``"hold"`` — and records non-hold decisions in
        ``scale_events``.

        With the telemetry plane on, the p99 comes from the SLO
        burn-rate monitor's fast window over the *fleet-aggregated*
        latency histogram (worker shipments merged first) instead of the
        parent-only baseline — and a sustained burn-rate breach takes
        one deduped flight-recorder dump (`obs/slo.py`)."""
        self.router.harvest_latencies()
        if self.slo_monitor is not None:
            self.poll_telemetry()
            p99 = self.slo_monitor.tick().get("p99_fast")
            self._lat_baseline = self._lat_hist.counts()
        else:
            p99 = self._lat_hist.quantile_since(self._lat_baseline, 0.99)
            self._lat_baseline = self._lat_hist.counts()
        ready = self.ready_replicas()
        if not ready:
            if len(self.replicas) < self.cfg.max_replicas:
                before = 0
                name = self.spawn_replica()
                self._m_scale_up.inc()
                self._record_scale("scale_up", "no_ready_replica", 0.0,
                                   before, len(self.ready_replicas()))
                return f"scale_up:{name}"
            return "hold"
        depth = self.router.total_pending()
        per_replica = depth / len(ready)
        if len(ready) < self.cfg.max_replicas:
            # SLO breach: measured p99 over the SLO target
            if p99 is not None and p99 > self.cfg.slo_p99_s:
                self._idle_ticks = 0
                before = len(ready)
                name = self.spawn_replica()
                self._m_scale_up.inc()
                self._record_scale("scale_up", "p99_latency", p99,
                                   before, len(self.ready_replicas()))
                return f"scale_up:{name}"
            # fast path: a deep queue predicts the breach before enough
            # completions exist to measure it
            if per_replica > self.cfg.scale_up_queue_per_replica:
                self._idle_ticks = 0
                before = len(ready)
                name = self.spawn_replica()
                self._m_scale_up.inc()
                self._record_scale("scale_up", "queue_depth", per_replica,
                                   before, len(self.ready_replicas()))
                return f"scale_up:{name}"
        slo_ok = (p99 is None
                  or p99 < self.cfg.slo_p99_s * self.cfg.slo_scale_down_factor)
        if slo_ok and per_replica < self.cfg.scale_down_queue_per_replica:
            self._idle_ticks += 1
            if (self._idle_ticks >= self.cfg.scale_down_grace_ticks
                    and len(ready) > self.cfg.min_replicas):
                self._idle_ticks = 0
                # retire the replica with the shallowest queue (cheapest
                # drain); ties break on name for determinism
                name = min(ready, key=lambda n: (
                    self.replicas[n].service.scheduler.queue_depth, n))
                before = len(ready)
                self.drain_replica(name)
                self._m_scale_down.inc()
                self._record_scale("scale_down", "slo_satisfied",
                                   p99 if p99 is not None else 0.0,
                                   before, len(self.ready_replicas()))
                return f"scale_down:{name}"
        else:
            self._idle_ticks = 0
        return "hold"

    def start_autoscaler(self) -> None:
        """Run maintenance + autoscale ticks on a daemon thread every
        ``autoscale_interval_s`` until ``close()``."""
        if self._autoscaler is not None:
            return

        def loop():
            while not self._stop.wait(self.cfg.autoscale_interval_s):
                try:
                    self.maintenance_tick()
                    self.autoscale_tick()
                except Exception:  # noqa: BLE001 — scaling must not
                    traceback.print_exc()      # crash serving; report it

        self._autoscaler = threading.Thread(
            target=loop, daemon=True, name="difet-fleet-autoscaler")
        self._autoscaler.start()

    # ---- client surface -----------------------------------------------------
    def submit(self, image, algorithms, tenant: str = "default",
               scene_key: Optional[str] = None,
               request_id: Optional[str] = None):
        """Router passthrough (see `serve/router.py::Router.submit`)."""
        return self.router.submit(image, algorithms, tenant=tenant,
                                  scene_key=scene_key,
                                  request_id=request_id)

    def extract(self, image, algorithms, tenant: str = "default",
                scene_key: Optional[str] = None,
                timeout: Optional[float] = None):
        """Synchronous convenience: submit + wait."""
        return self.submit(image, algorithms, tenant=tenant,
                           scene_key=scene_key).result(timeout)

    def register_scene(self, name: str, image) -> None:
        """Broadcast a scene id to every replica (current and future), so
        ``submit(name, ...)`` works wherever the request routes."""
        self._scenes[name] = image
        with self._lock:
            reps = list(self.replicas.values())
        for rep in reps:
            if rep.state in (READY, WARMING, DRAINING):
                rep.service.register_scene(name, image)

    def stats(self) -> Dict[str, object]:
        """Router aggregate + per-replica lifecycle states + the
        autoscaler's decision log."""
        s = self.router.stats()
        with self._lock:
            s["states"] = {n: r.state for n, r in self.replicas.items()}
            s["scale_events"] = [dict(e) for e in self.scale_events]
        s["ready"] = sum(1 for v in s["states"].values() if v == READY)
        return s

    def close(self, timeout: float = 60.0) -> None:
        """Shut the fleet down: stop the autoscaler, stop admitting,
        drain every live replica (accepted work completes), and reap any
        dead worker processes."""
        self._stop.set()
        if self._autoscaler is not None:
            self._autoscaler.join(self.cfg.autoscale_interval_s + 5.0)
            self._autoscaler = None
        self.router.close()
        for name in list(self.replicas):
            self.drain_replica(name, timeout)
        self.poll_telemetry()     # sweep any last shipments
        with self._lock:
            reps = list(self.replicas.values())
        for rep in reps:
            if rep.kind == "proc" and rep.service.alive():
                chaos.sigkill(rep.service.pid)
