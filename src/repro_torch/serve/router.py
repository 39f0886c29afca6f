"""Fleet front-end: consistent-hash affinity routing, admission control,
per-tenant rate limits, and crash re-admission.

Port of ``repro/serve/router.py`` (host code over the port's
`serve/api.py::FeatureService`).

One :class:`Router` fronts N `serve/api.py::FeatureService` replicas (the
pool is managed by `serve/fleet.py::Fleet`; the router only needs a
name → replica map).  A request flows:

    submit(image, algorithms, tenant, scene_key)
      → admission control: per-tenant token bucket, then the bounded
        *global* queue (sum of replica queue depths) — violations raise a
        typed :class:`Shed` (reason + retry-after) instead of a raw
        ``ServiceOverloaded``, so clients can tell "slow down" from
        "you specifically are over quota"
      → routing: consistent-hash on the scene/content key picks the
        *affinity* replica — repeats of a hot scene land on the replica
        whose result cache and batch groups already hold it; when that
        replica's queue is deep (hot-scene hotspot) the router spills to
        the least-pending replica instead (affinity is a cache
        optimization, never a correctness constraint — extraction is
        deterministic, so any replica computes the same bits)
      → the request is registered in the outstanding table, submitted to
        the replica, and a :class:`FleetHandle` returned.

Crash handling: when a replica dies (`Fleet.kill_replica`, or a stale
liveness lease), every outstanding request routed to it is *re-admitted*
— re-submitted to a surviving replica, bypassing admission (it was
already accepted; accepted work is never shed).  The dead replica's
futures carry `serve/scheduler.py::ReplicaDied`; `FleetHandle.result`
swallows that and waits for the re-dispatch, so callers just see the
request complete — bit-identically, because extraction is deterministic
and the result cache keys on content.  Both halves of the race (batch
completed vs kill won) deliver the same bits.
"""
from __future__ import annotations

import bisect
import dataclasses
import hashlib
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.api import ExtractResponse, FeatureService
from repro_torch.serve.scheduler import (ReplicaDied, ServiceClosed,
                                   ServiceOverloaded)

__all__ = ["RouterConfig", "Router", "FleetHandle", "Shed", "TokenBucket",
           "HashRing", "SHED_TENANT_THROTTLED", "SHED_FLEET_SATURATED",
           "SHED_NO_REPLICA", "SHED_CLOSED"]

# typed shed reasons
SHED_TENANT_THROTTLED = "tenant_throttled"   # this tenant is over quota
SHED_FLEET_SATURATED = "fleet_saturated"     # global queue bound hit
SHED_NO_REPLICA = "no_ready_replica"         # pool empty / all draining
SHED_CLOSED = "closed"                       # router shut down


class Shed(ServiceOverloaded):
    """Typed load-shed response.  Subclasses ``ServiceOverloaded`` so
    single-service callers keep working, but carries *why* the request
    was shed (``reason``), *who* was shedding (``tenant`` for quota
    sheds) and a ``retry_after_s`` hint."""

    def __init__(self, reason: str, detail: str = "",
                 tenant: Optional[str] = None,
                 retry_after_s: float = 0.0):
        super().__init__(detail or reason)
        self.reason = reason
        self.tenant = tenant
        self.retry_after_s = retry_after_s


class TokenBucket:
    """Thread-safe token bucket: ``rate`` tokens/s refill up to ``burst``
    capacity; ``take()`` spends one.  ``rate=inf`` never throttles."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = self.burst
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def take(self) -> Tuple[bool, float]:
        """Try to spend one token.  Returns ``(ok, retry_after_s)`` —
        on refusal, how long until one token refills."""
        if self.rate == float("inf"):
            return True, 0.0
        with self._lock:
            now = time.monotonic()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True, 0.0
            return False, (1.0 - self._tokens) / max(self.rate, 1e-9)


def _hash64(s: str) -> int:
    return int.from_bytes(hashlib.sha256(s.encode()).digest()[:8], "big")


class HashRing:
    """Consistent-hash ring with virtual nodes.  Adding/removing one
    replica only remaps the keys that hashed to it — every other key
    keeps its replica (and therefore its warm caches), which is the whole
    point of consistent hashing for cache-affinity routing (tested)."""

    def __init__(self, vnodes: int = 64):
        self.vnodes = int(vnodes)
        self._ring: List[Tuple[int, str]] = []   # sorted (position, name)
        self._names: set = set()

    def add(self, name: str) -> None:
        """Insert ``vnodes`` virtual nodes for a replica (idempotent)."""
        if name in self._names:
            return
        self._names.add(name)
        for v in range(self.vnodes):
            bisect.insort(self._ring, (_hash64(f"{name}#{v}"), name))

    def remove(self, name: str) -> None:
        """Drop a replica's virtual nodes (idempotent)."""
        if name not in self._names:
            return
        self._names.discard(name)
        self._ring = [(p, n) for p, n in self._ring if n != name]

    @property
    def names(self) -> Tuple[str, ...]:
        """Replica names currently on the ring, sorted."""
        return tuple(sorted(self._names))

    def lookup(self, key: str) -> Optional[str]:
        """The replica owning ``key`` (first vnode clockwise), or None on
        an empty ring."""
        if not self._ring:
            return None
        i = bisect.bisect_left(self._ring, (_hash64(key), ""))
        if i == len(self._ring):
            i = 0
        return self._ring[i][1]


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Admission + routing knobs.

    ``max_global_pending`` bounds the *fleet-wide* queue (sum of replica
    queue depths) — beyond it requests shed with
    :data:`SHED_FLEET_SATURATED`.  ``spill_queue_threshold`` is the
    affinity replica's queue depth beyond which the router abandons
    affinity for the least-pending replica (hot-scene hotspot relief).
    ``tenant_rate``/``tenant_burst`` are the default per-tenant token
    bucket (``inf`` = unthrottled); ``tenant_limits`` overrides specific
    tenants with ``{tenant: (rate, burst)}``."""
    max_global_pending: int = 4096
    spill_queue_threshold: int = 16
    vnodes: int = 64
    tenant_rate: float = float("inf")
    tenant_burst: float = 64.0
    tenant_limits: Optional[Dict[str, Tuple[float, float]]] = None


class _Slot:
    """Router-side view of one replica: the service + whether the router
    may send it new work (False while draining)."""

    def __init__(self, service: FeatureService):
        self.service = service
        self.accepting = True


class _FleetRequest:
    """Outstanding-table entry: enough payload to re-admit the request if
    its replica dies, plus the live inner handle + a generation counter
    bumped on every re-dispatch."""

    def __init__(self, rid: str, image, algorithms, tenant: str,
                 route_key: str, replica: str, handle,
                 trace_id: str = "", admitted_at: float = 0.0):
        self.rid = rid
        self.image = image
        self.algorithms = algorithms
        self.tenant = tenant
        self.route_key = route_key
        self.replica = replica
        self.handle = handle
        self.trace_id = trace_id
        self.admitted_at = admitted_at   # wall clock at admission (SLO base)
        self.latency_observed = False    # each request counts once
        self.generation = 0
        self.error: Optional[BaseException] = None


class FleetHandle:
    """Deferred fleet response.  ``result()`` delegates to the current
    replica-level handle; if that replica died mid-flight it waits for
    the router's re-admission (generation bump) and retries — the caller
    never sees :class:`ReplicaDied`."""

    def __init__(self, router: "Router", req: _FleetRequest):
        self._router = router
        self._req = req

    @property
    def request_id(self) -> str:
        """The fleet-assigned request id (stable across re-admissions)."""
        return self._req.rid

    def done(self) -> bool:
        """Non-blocking readiness probe (False while a re-admitted
        request is still recomputing)."""
        with self._router._cv:
            if self._req.error is not None:
                return True
            return self._req.handle.done()

    def result(self, timeout: Optional[float] = None) -> ExtractResponse:
        """Wait for the request across any number of re-admissions."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._router._cv:
                if self._req.error is not None:
                    raise self._req.error
                gen, inner = self._req.generation, self._req.handle
            rem = None if deadline is None else deadline - time.monotonic()
            if rem is not None and rem <= 0:
                raise TimeoutError(
                    f"request {self._req.rid} timed out")
            try:
                resp = inner.result(rem)
            except ReplicaDied:
                # our replica was killed: wait for the router to re-admit
                # (the fleet's maintenance tick does so as soon as the
                # stale lease is detected, so this is one TTL at worst)
                with self._router._cv:
                    while (self._req.generation == gen
                           and self._req.error is None):
                        rem = (None if deadline is None
                               else deadline - time.monotonic())
                        if rem is not None and rem <= 0:
                            raise TimeoutError(
                                f"request {self._req.rid} timed out "
                                f"waiting for re-admission")
                        self._router._cv.wait(rem)
                continue
            self._router._observe_latency(self._req, resp)
            self._router._complete(self._req.rid)
            return resp


class Router:
    """The fleet front-end (see module docstring).  Thread-safe: any
    number of client threads may ``submit`` while `serve/fleet.py` adds,
    drains, or removes replicas."""

    def __init__(self, cfg: Optional[RouterConfig] = None):
        self.cfg = cfg or RouterConfig()
        self._cv = threading.Condition()
        self._slots: Dict[str, _Slot] = {}
        self._ring = HashRing(self.cfg.vnodes)
        self._outstanding: Dict[str, _FleetRequest] = {}
        self._buckets: Dict[str, TokenBucket] = {}
        self._closed = False
        self._rid = 0
        # counters
        self.submitted = 0
        self.readmitted = 0
        self.routed_affinity = 0
        self.routed_spill = 0
        self.shed_by_reason: Dict[str, int] = {}
        self.tenant_counts: Dict[str, Dict[str, int]] = {}
        # bounded shed/readmit event feed: the fleet drains this into
        # the telemetry aggregator's correlation log (obs/agg.py)
        # so worker flight-recorder dumps can be joined with the parent
        # admission decisions taken around them
        self._events: List[Dict[str, object]] = []
        # registry mirrors (difet.router.*) for the per-run metrics JSON
        _reg = obs_metrics.registry()
        self._m_admitted = _reg.counter("difet.router.admitted")
        self._m_readmitted = _reg.counter("difet.router.readmitted")
        self._m_affinity = _reg.counter("difet.router.routed_affinity")
        self._m_spill = _reg.counter("difet.router.routed_spill")
        # admission → work-completion latency, the SLO the fleet
        # autoscaler controls on (`serve/fleet.py::Fleet.autoscale_tick`)
        self._m_latency = _reg.histogram("difet.fleet.request_latency_s")

    # ---- pool membership (called by Fleet) ---------------------------------
    def add_replica(self, name: str, service: FeatureService) -> None:
        """Add a READY replica to the routable pool + hash ring."""
        with self._cv:
            self._slots[name] = _Slot(service)
            self._ring.add(name)
            self._cv.notify_all()

    def set_accepting(self, name: str, accepting: bool) -> None:
        """Drain gate: ``False`` removes the replica from the ring (no new
        work routes to it) while its queued work finishes."""
        with self._cv:
            slot = self._slots.get(name)
            if slot is None:
                return
            slot.accepting = accepting
            (self._ring.add if accepting else self._ring.remove)(name)

    def remove_replica(self, name: str, died: bool = False) -> None:
        """Drop a replica; ``died=True`` re-admits its outstanding
        requests to the survivors (crash path)."""
        with self._cv:
            self._slots.pop(name, None)
            self._ring.remove(name)
        if died:
            self.readmit(name)

    def replica_names(self) -> Tuple[str, ...]:
        """Names of every replica the router can currently reach."""
        with self._cv:
            return tuple(sorted(self._slots))

    def drain_events(self) -> List[Dict[str, object]]:
        """Hand over (and clear) the bounded shed/readmit event feed —
        consumed by `serve/fleet.py::Fleet.poll_telemetry` into the
        telemetry aggregator's dump-correlation log."""
        with self._cv:
            out, self._events = self._events, []
        return out

    # ---- admission + routing ----------------------------------------------
    def _bucket(self, tenant: str) -> TokenBucket:
        b = self._buckets.get(tenant)
        if b is None:
            rate, burst = (self.cfg.tenant_limits or {}).get(
                tenant, (self.cfg.tenant_rate, self.cfg.tenant_burst))
            b = self._buckets.setdefault(tenant, TokenBucket(rate, burst))
        return b

    def _shed(self, reason: str, tenant: str, detail: str = "",
              retry_after_s: float = 0.0):
        with self._cv:
            self.shed_by_reason[reason] = \
                self.shed_by_reason.get(reason, 0) + 1
            t = self.tenant_counts.setdefault(
                tenant, {"admitted": 0, "shed": 0})
            t["shed"] += 1
            self._events.append({"kind": "shed", "reason": reason,
                                 "tenant": tenant, "t": time.monotonic()})
            del self._events[:-256]
        obs_metrics.registry().counter(f"difet.router.shed.{reason}").inc()
        rec = obs_trace.get_recorder()
        if rec.enabled:
            # a shed is an operator-actionable event: snapshot what the
            # fleet was doing when it happened (deduped per reason)
            getattr(rec, "dump_on", lambda _r: None)(f"shed-{reason}")
        raise Shed(reason, detail, tenant=tenant,
                   retry_after_s=retry_after_s)

    def _route_key(self, image, scene_key: Optional[str]) -> str:
        if scene_key is not None:
            return scene_key
        if isinstance(image, str):
            return image                     # registered scene id
        if isinstance(image, (bytes, bytearray)):
            return hashlib.sha256(bytes(image)).hexdigest()
        a = np.ascontiguousarray(image)
        return hashlib.sha256(a.tobytes()).hexdigest()

    def _pick(self, key: str) -> Tuple[Optional[str], bool]:
        """(replica name, spilled?) under the lock: affinity target unless
        its queue is past the spill threshold and someone is shallower."""
        target = self._ring.lookup(key)
        if target is None:
            return None, False
        depth = self._slots[target].service.scheduler.queue_depth
        if depth < self.cfg.spill_queue_threshold:
            return target, False
        best, best_depth = target, depth
        for name, slot in self._slots.items():
            if not slot.accepting:
                continue
            d = slot.service.scheduler.queue_depth
            if d < best_depth:
                best, best_depth = name, d
        return best, best != target

    def total_pending(self) -> int:
        """Fleet-wide queue depth (the bounded global queue)."""
        with self._cv:
            slots = list(self._slots.values())
        return sum(s.service.scheduler.queue_depth for s in slots)

    def submit(self, image, algorithms, tenant: str = "default",
               scene_key: Optional[str] = None,
               request_id: Optional[str] = None) -> FleetHandle:
        """Admit + route one request; returns a :class:`FleetHandle`.

        Raises :class:`Shed` (typed: reason/tenant/retry-after) when the
        tenant is over its token bucket, the fleet-wide queue is at
        ``max_global_pending``, or no replica is accepting work.  Never
        blocks the caller on backpressure — shedding at the edge is the
        contract."""
        if self._closed:
            self._shed(SHED_CLOSED, tenant, "router is closed")
        ok, retry = self._bucket(tenant).take()
        if not ok:
            self._shed(SHED_TENANT_THROTTLED, tenant,
                       f"tenant {tenant!r} over rate limit",
                       retry_after_s=retry)
        if self.total_pending() >= self.cfg.max_global_pending:
            self._shed(SHED_FLEET_SATURATED, tenant,
                       f"fleet queue at max_global_pending="
                       f"{self.cfg.max_global_pending}")
        key = self._route_key(image, scene_key)
        with self._cv:
            name, spilled = self._pick(key)
            if name is None:
                # release the lock before raising (shed takes it again)
                pass
            else:
                slot = self._slots[name]
        if name is None:
            self._shed(SHED_NO_REPLICA, tenant, "no replica accepting work")
        # trace id minted at admission (the request passed every gate):
        # it follows the request through the replica scheduler, batch
        # execution, the cache tiers, and crash re-admission
        tracing = obs_trace.enabled()
        tid = obs_trace.new_trace_id() if tracing else ""
        t_admit = time.monotonic() if tracing else 0.0
        admitted_at = time.time()        # SLO latency base (wall clock,
        #                                  comparable to timing["completed_at"])
        try:
            handle = slot.service.submit(image, algorithms,
                                         request_id=request_id, block=False,
                                         trace_id=tid)
        except (ServiceOverloaded, ServiceClosed):
            # the chosen replica itself refused (its local queue bound is
            # tighter than the global one, or it closed under us): one
            # retry on the least-pending other replica, then shed
            alt = self._least_pending(exclude=name)
            if alt is None:
                self._shed(SHED_FLEET_SATURATED, tenant,
                           f"replica {name} overloaded, no alternative")
            try:
                handle = self._slots[alt].service.submit(
                    image, algorithms, request_id=request_id, block=False,
                    trace_id=tid)
                name, spilled = alt, True
            except (ServiceOverloaded, ServiceClosed):
                self._shed(SHED_FLEET_SATURATED, tenant,
                           "all replicas overloaded")
        with self._cv:
            self._rid += 1
            rid = request_id or f"fleet-{self._rid:08d}"
            req = _FleetRequest(rid, image, tuple(algorithms) if
                                not isinstance(algorithms, str)
                                else algorithms, tenant, key, name, handle,
                                trace_id=tid, admitted_at=admitted_at)
            self._outstanding[rid] = req
            self.submitted += 1
            if spilled:
                self.routed_spill += 1
            else:
                self.routed_affinity += 1
            t = self.tenant_counts.setdefault(
                tenant, {"admitted": 0, "shed": 0})
            t["admitted"] += 1
        self._m_admitted.inc()
        (self._m_spill if spilled else self._m_affinity).inc()
        if tracing:
            obs_trace.emit_span("admit", "router", t_admit, time.monotonic(),
                                trace_id=tid, rid=rid, tenant=tenant,
                                replica=name, spilled=spilled)
        return FleetHandle(self, req)

    def extract(self, image, algorithms, tenant: str = "default",
                scene_key: Optional[str] = None,
                timeout: Optional[float] = None) -> ExtractResponse:
        """Synchronous convenience: submit + wait."""
        return self.submit(image, algorithms, tenant=tenant,
                           scene_key=scene_key).result(timeout)

    def _least_pending(self, exclude: Optional[str] = None) -> Optional[str]:
        with self._cv:
            cands = [(s.service.scheduler.queue_depth, n)
                     for n, s in self._slots.items()
                     if s.accepting and n != exclude]
        return min(cands)[1] if cands else None

    # ---- crash re-admission -------------------------------------------------
    def readmit(self, dead_replica: str) -> int:
        """Re-dispatch every outstanding request routed to a dead replica
        onto the survivors.  Accepted work is never shed: re-admission
        bypasses admission control (the request already passed it) and
        blocks for queue room if it must.  Returns the number of requests
        re-admitted."""
        with self._cv:
            victims = [r for r in self._outstanding.values()
                       if r.replica == dead_replica]
        n = 0
        for req in victims:
            if req.handle.done():
                # finished before (or racing) the crash: either a real
                # result (deliverable — determinism makes it correct) or
                # ReplicaDied (handled below on the next loop)
                try:
                    if not self._handle_failed(req.handle):
                        continue
                except Exception:  # noqa: BLE001 — treat as failed
                    pass
            target = self._least_pending(exclude=dead_replica)
            if target is None:
                with self._cv:
                    req.error = Shed(SHED_NO_REPLICA,
                                     "replica died and no survivor "
                                     "accepts work", tenant=req.tenant)
                    self._cv.notify_all()
                continue
            t0 = time.monotonic()
            try:
                new_handle = self._slots[target].service.submit(
                    req.image, req.algorithms, request_id=req.rid,
                    block=True, trace_id=req.trace_id)
            except (ServiceOverloaded, ServiceClosed) as e:
                with self._cv:
                    req.error = e
                    self._cv.notify_all()
                continue
            with self._cv:
                req.replica = target
                req.handle = new_handle
                req.generation += 1
                self.readmitted += 1
                self._events.append(
                    {"kind": "readmit", "rid": req.rid,
                     "from": dead_replica, "to": target,
                     "t": time.monotonic()})
                del self._events[:-256]
                self._cv.notify_all()
            self._m_readmitted.inc()
            if obs_trace.enabled():
                # links the dead replica's spans to the recompute: same
                # trace id as the original admission, old/new replica
                # named in the attrs (chaos-tested)
                obs_trace.emit_span("readmit", "router", t0,
                                    time.monotonic(),
                                    trace_id=req.trace_id, rid=req.rid,
                                    old_replica=dead_replica,
                                    new_replica=target)
            n += 1
        return n

    @staticmethod
    def _handle_failed(handle) -> bool:
        """True iff a done replica-handle holds a died-without-result
        failure (probe without blocking).  Duck-typed over both replica
        kinds: process handles (`serve/proc.py::ProcHandle`) expose
        ``failed()`` directly; thread handles are probed through their
        per-part futures."""
        probe = getattr(handle, "failed", None)
        if callable(probe):
            return bool(probe())
        for p in handle._parts:
            if p.future is not None and p.future.done():
                if p.future.exception() is not None:
                    return True
        return False

    # ---- SLO latency ---------------------------------------------------------
    def _observe_latency(self, req: _FleetRequest,
                         resp: ExtractResponse) -> None:
        """Record one admission→work-completion latency into the fleet
        SLO histogram (idempotent per request — ``result()`` can be
        called repeatedly and `harvest_latencies` races it benignly)."""
        with self._cv:
            if req.latency_observed or not req.admitted_at:
                return
            req.latency_observed = True
        completed = resp.timing.get("completed_at") or time.time()
        self._m_latency.observe(max(0.0, completed - req.admitted_at))

    def harvest_latencies(self) -> int:
        """Observe the latency of every *done but uncollected* request —
        the autoscaler's view under open-loop clients that submit fast
        and collect late (without this, p99 would only reflect requests
        whose callers already drained them).  Returns how many were
        harvested this call."""
        with self._cv:
            todo = [r for r in self._outstanding.values()
                    if not r.latency_observed and r.error is None]
        n = 0
        for req in todo:
            try:
                if not req.handle.done() or self._handle_failed(req.handle):
                    continue
                resp = req.handle.result(0.05)
            except Exception:  # noqa: BLE001 — died/raced: its turn comes later
                continue
            self._observe_latency(req, resp)
            n += 1
        return n

    def _complete(self, rid: str) -> None:
        with self._cv:
            self._outstanding.pop(rid, None)

    @property
    def outstanding(self) -> int:
        """Accepted requests not yet collected by their callers."""
        with self._cv:
            return len(self._outstanding)

    # ---- ops ----------------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        """Fleet-aggregated counters: router admission/routing totals,
        per-tenant admit/shed, and the per-replica ``FeatureService``
        snapshots (plus their summed cache/queue totals)."""
        with self._cv:
            slots = dict(self._slots)
            snap = {
                "submitted": self.submitted,
                "shed": dict(self.shed_by_reason),
                "shed_total": sum(self.shed_by_reason.values()),
                "routed_affinity": self.routed_affinity,
                "routed_spill": self.routed_spill,
                "readmitted": self.readmitted,
                "outstanding": len(self._outstanding),
                "tenants": {t: dict(c)
                            for t, c in self.tenant_counts.items()},
            }
        per_replica = {n: s.service.stats() for n, s in slots.items()}
        snap["replicas"] = per_replica
        snap["replica_count"] = len(per_replica)
        snap["total_queue_depth"] = sum(r["queue_depth"]
                                        for r in per_replica.values())
        snap["total_cache_hits"] = sum(r["cache_hits"]
                                       for r in per_replica.values())
        snap["total_cache_misses"] = sum(r["cache_misses"]
                                         for r in per_replica.values())
        snap["total_busy_s"] = sum(r["busy_s"]
                                   for r in per_replica.values())
        qs = [r["p99_queue_ms"] for r in per_replica.values()
              if r["batches"]]
        snap["max_p99_queue_ms"] = max(qs) if qs else 0.0
        return snap

    def close(self) -> None:
        """Stop admitting (subsequent submits shed with ``closed``)."""
        self._closed = True
