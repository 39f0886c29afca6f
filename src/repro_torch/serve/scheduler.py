"""Continuous-batching scheduler for the feature service.

Requests arrive one tile at a time; the device wants full batches.  The
scheduler keeps a FIFO of pending work items, and a single runner thread
repeatedly forms the next batch: it takes the *oldest* pending item, whose
``(bucket, algorithm-set)`` group keys the step, waits until either
``max_batch`` same-group items are pending or the head item has aged past
``max_batch_delay_s`` (the latency/throughput knob), then pops up to
``max_batch`` group members in arrival order and hands them to the runner
callback — which pads the batch to the fixed device shape and runs the
bucket's compiled program.  While a device step executes, new arrivals
keep queueing, so the next batch forms the moment the step returns:
continuous batching, no generation barriers.

Backpressure: at most ``max_pending`` items may be queued; beyond that
``submit`` raises :class:`ServiceOverloaded` (or blocks when asked to),
so a slow device surfaces as load-shedding at the edge instead of an
unbounded queue.

Determinism: batches are formed in arrival (seq) order, and per-request
results are batch-invariant (`core/engine.py::extract_request_features`),
so the *same request set in any arrival order yields bit-identical
per-request results* — tested in ``tests/test_torch_serve.py``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


class ServiceOverloaded(RuntimeError):
    """Raised by ``submit`` when the pending queue is at ``max_pending``."""


class ServiceClosed(RuntimeError):
    """Raised by ``submit`` once the scheduler is stopping or stopped —
    including for submitters already *blocked* on backpressure when
    ``stop()``/``kill()`` arrives: shutdown wakes them and raises this
    instead of leaving them parked on the condition variable."""


class ReplicaDied(RuntimeError):
    """Set on every unresolved future when a replica is ``kill()``-ed —
    the fleet router catches it and re-admits the work elsewhere
    (`serve/router.py`); extraction is deterministic, so re-execution is
    bit-identical."""


@dataclasses.dataclass
class WorkItem:
    """One tile awaiting a device step.  ``future`` resolves to the
    per-algorithm feature dict for this tile; ``digest``/``cfg_digest``
    ride along so the runner can insert results into the result cache.

    Future resolution goes through :meth:`resolve`/:meth:`fail` only —
    ``stop()``/``kill()`` race the in-flight ``_run_batch`` by design
    (the kill path fails every active item while the runner may be
    setting its result), and the old ad-hoc ``done()``-then-set guards
    at each call site still allowed both sides to believe they won.
    The settle flag makes first-wins explicit and auditable
    (regression-tested in ``tests/test_torch_serve.py``)."""
    seq: int
    tile: np.ndarray                 # [hw, hw] float32, bucket-padded
    header: np.ndarray               # [6] int32
    bucket: int
    algorithms: Tuple[str, ...]
    digest: str
    cfg_digest: str
    future: Future
    enqueued_at: float = 0.0
    batch_size: int = 0              # filled by the runner
    completed_at: float = 0.0        # wall clock at batch completion (runner)
    trace_id: str = ""               # minted at router admission (obs/trace)
    settled: bool = False            # first resolve/fail wins; rest no-op
    _settle_lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False)

    @property
    def group_key(self) -> tuple:
        return (self.bucket, self.algorithms)

    def _claim(self) -> bool:
        with self._settle_lock:
            if self.settled:
                return False
            self.settled = True
            return True

    def resolve(self, value) -> bool:
        """Idempotently complete the item's future with ``value``;
        returns True iff this call won the settle race (a concurrent
        `fail` — e.g. ``kill()`` vs batch completion — is benign:
        exactly one side wins)."""
        if not self._claim():
            return False
        try:
            self.future.set_result(value)
        except InvalidStateError:      # future cancelled/settled externally
            return False
        return True

    def fail(self, exc: BaseException) -> bool:
        """Idempotently fail the item's future with ``exc``; returns
        True iff this call won the settle race."""
        if not self._claim():
            return False
        try:
            self.future.set_exception(exc)
        except InvalidStateError:
            return False
        return True


class BatchScheduler:
    """Single-runner continuous batcher over :class:`WorkItem` queues."""

    def __init__(self, run_batch: Callable[[int, Tuple[str, ...],
                                            Sequence[WorkItem]], None],
                 *, max_batch: int = 8, max_batch_delay_s: float = 0.002,
                 max_pending: int = 1024, name: str = "difet-serve"):
        self._run_batch = run_batch
        self.max_batch = int(max_batch)
        self.max_batch_delay_s = float(max_batch_delay_s)
        self.max_pending = int(max_pending)
        self._cv = threading.Condition()
        self._pending: List[WorkItem] = []
        self._active: List[WorkItem] = []   # the batch currently on-device
        self._seq = 0
        self._stopping = False
        self._killed = False
        self.batches = 0
        self.items = 0
        self.rejected = 0
        self.batch_size_hist: Dict[int, int] = {}
        # queue latency (enqueue → batch completion, seconds) — observed
        # by the service runner into a fixed-bucket histogram: bounded
        # memory forever (the old per-request deque grew with traffic and
        # its np.percentile sorted on every stats() poll), quantiles
        # answered by interpolated bucket walk (obs/metrics.py)
        self.queue_hist = obs_metrics.Histogram(f"{name}.queue_s")
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=name)
        self._thread.start()

    # ---- client side -------------------------------------------------------
    def submit(self, tile, header, bucket, algorithms, digest="",
               cfg_digest="", block: bool = False,
               timeout: Optional[float] = None,
               trace_id: str = "") -> Future:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            if self._stopping:
                raise ServiceClosed("scheduler is stopped")
            while len(self._pending) >= self.max_pending:
                if not block:
                    self.rejected += 1
                    raise ServiceOverloaded(
                        f"{len(self._pending)} tiles pending "
                        f"(max_pending={self.max_pending})")
                rem = None if deadline is None else deadline - time.monotonic()
                if rem is not None and rem <= 0:
                    self.rejected += 1
                    raise ServiceOverloaded("timed out waiting for queue room")
                self._cv.wait(rem)
                # shutdown must wake blocked submitters: without this
                # re-check a submitter parked on backpressure would hang
                # across stop()/kill() (regression-tested)
                if self._stopping:
                    raise ServiceClosed("scheduler stopped while waiting "
                                        "for queue room")
            item = WorkItem(seq=self._seq, tile=np.asarray(tile, np.float32),
                            header=np.asarray(header, np.int32),
                            bucket=int(bucket),
                            algorithms=tuple(algorithms), digest=digest,
                            cfg_digest=cfg_digest, future=Future(),
                            enqueued_at=time.monotonic(),
                            trace_id=trace_id)
            self._seq += 1
            self._pending.append(item)
            self._cv.notify_all()
            return item.future

    @property
    def queue_depth(self) -> int:
        with self._cv:
            return len(self._pending)

    # ---- runner side -------------------------------------------------------
    def _take_batch(self) -> Tuple[tuple, List[WorkItem]]:
        """Form the next batch (called with the lock held, queue non-empty):
        oldest item keys the group; wait for fill or the head's deadline."""
        head = self._pending[0]
        key = head.group_key
        deadline = head.enqueued_at + self.max_batch_delay_s
        while not self._stopping:
            group = [it for it in self._pending if it.group_key == key]
            if len(group) >= self.max_batch:
                break
            rem = deadline - time.monotonic()
            if rem <= 0:
                break
            self._cv.wait(rem)
        group = [it for it in self._pending
                 if it.group_key == key][:self.max_batch]
        taken = {it.seq for it in group}
        self._pending = [it for it in self._pending if it.seq not in taken]
        return key, group

    def _loop(self):
        while True:
            with self._cv:
                while not self._pending and not self._stopping:
                    self._cv.wait()
                if not self._pending and self._stopping:
                    return
                (bucket, algorithms), batch = self._take_batch()
                if not batch:                  # kill() raced the take
                    continue
                self.batches += 1
                self.items += len(batch)
                self.batch_size_hist[len(batch)] = \
                    self.batch_size_hist.get(len(batch), 0) + 1
                self._active = list(batch)
                self._cv.notify_all()          # wake backpressure waiters
            for it in batch:
                it.batch_size = len(batch)
            try:
                self._run_batch(bucket, algorithms, batch)
            except BaseException as e:  # noqa: BLE001 — fail the batch, not the service
                for it in batch:
                    it.fail(e)                 # no-op if kill() already won
            finally:
                with self._cv:
                    self._active = []
                    if self._killed:
                        return

    def stop(self, timeout: Optional[float] = None):
        """Drain the queue, then stop the runner thread.  Submitters
        blocked on backpressure are woken and raise :class:`ServiceClosed`
        instead of hanging."""
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        self._thread.join(timeout)

    def kill(self, exc: Optional[BaseException] = None):
        """Crash the scheduler *without* draining (chaos path): every
        pending and in-flight (on-device) item's future fails with ``exc``
        (default :class:`ReplicaDied`) so a fleet router can re-admit the
        work; blocked submitters wake with :class:`ServiceClosed`.  An
        in-flight batch that completes concurrently wins the future race
        benignly — extraction is deterministic, so either outcome carries
        the same bits."""
        exc = exc or ReplicaDied("replica killed")
        with self._cv:
            self._stopping = True
            self._killed = True
            victims = self._pending + self._active
            self._pending = []
            self._cv.notify_all()
        rec = obs_trace.get_recorder()
        if rec.enabled:
            now = time.monotonic()
            for it in victims:                 # mark the orphaned work
                obs_trace.emit_span("killed", "scheduler", it.enqueued_at,
                                    now, trace_id=it.trace_id,
                                    scheduler=self._thread.name,
                                    exc=type(exc).__name__)
            # flight-recorder artifact: what the replica was doing when
            # it died (deduped per reason inside dump_on)
            getattr(rec, "dump_on", lambda _r: None)("replica_died")
        for it in victims:
            it.fail(exc)                       # no-op if the batch finished first

    def stats(self) -> Dict[str, object]:
        """Counter snapshot: totals, queue depth, batch-size histogram /
        mean occupancy, and p50/p99 queue latency (enqueue → batch
        completion) estimated from the bounded fixed-bucket histogram
        (`obs/metrics.py::Histogram` — constant memory at any traffic
        volume, interpolated quantiles)."""
        with self._cv:
            snap = {"batches": self.batches, "items": self.items,
                    "submitted": self._seq,
                    "rejected": self.rejected,
                    "queue_depth": len(self._pending),
                    "inflight": len(self._active),
                    "batch_size_hist": dict(sorted(
                        self.batch_size_hist.items())),
                    "mean_batch": (self.items / self.batches
                                   if self.batches else 0.0)}
        snap["occupancy"] = snap["mean_batch"] / self.max_batch
        snap["p50_queue_ms"] = self.queue_hist.quantile(0.50) * 1e3
        snap["p99_queue_ms"] = self.queue_hist.quantile(0.99) * 1e3
        return snap
