"""Request/response model + facade for the DIFET feature service.

Port of ``repro/serve/api.py``: the same service on the port's engine,
with each (bucket, algorithm-set) step a CUDA graph replayed on the card
(`serve/buckets.py::ServeGraph`).

DIFET is feature extraction *as a service*: downstream consumers (the
companion stitching pipeline, arXiv:1808.08522; siftservice.com-style
online clients, arXiv:1504.02840) submit a tile — raw pixels, ``.npy``
bytes, or a registered scene id — plus an algorithm list, and get back
keypoints + descriptors + timing metadata.  ``FeatureService`` composes
the serving subsystem:

    submit(tile, algorithms)
      → normalize algorithms (`core/engine.py::normalize_algorithms`)
      → grayscale + bucket-pad (`serve/buckets.py`), or split oversize
        scenes into bucket tiles
      → per-(tile digest + grid position, algorithm, config digest)
        result-cache probe (`serve/cache.py`; position is in the key
        because results carry scene-global coordinates); fully-cached
        requests return without touching the device
      → misses coalesce with identical in-flight work, else enqueue on
        the continuous-batching scheduler (`serve/scheduler.py`)
      → the runner scatters the batch into the bucket's pinned canvas
        and runs the (bucket, algorithm-set) program — built exactly
        once (`serve/buckets.py::CompileCache`): on the card one replay
        of the captured graph of the engine's ``extract_request_features``
        (shared response maps, the CUDA kernels), then one copy of the
        packed outputs back to the host
      → results are frozen into the cache and the response assembled.

Served results are bit-identical to direct ``extract_features_multi``
calls on the same padded tile (engine batch-invariance; tested in
``tests/test_torch_serve.py`` and gated on the card by ``chip_smoke.py``),
so caching and batching are pure performance — never a numerics fork.
"""
from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.configs.difet_paper import DifetConfig
from repro_torch.core.bundle import rgba_to_gray, tile_scene
from repro_torch.core.engine import normalize_algorithms
from repro_torch.core.job import DifetJob
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.buckets import BucketTable, CompileCache, warmup
from repro_torch.serve.cache import ResultCache, TieredResultCache
from repro_torch.serve.scheduler import (BatchScheduler, ServiceClosed,
                                         ServiceOverloaded, WorkItem)

__all__ = ["ServeConfig", "FeatureService", "ExtractResponse",
           "ResponseHandle", "ServiceClosed", "ServiceOverloaded",
           "tile_digest", "config_digest", "encode_tile", "decode_tile"]


# ---- wire helpers ----------------------------------------------------------

def encode_tile(arr: np.ndarray) -> bytes:
    """Serialize a tile to ``.npy`` bytes (the service's wire format)."""
    buf = io.BytesIO()
    np.save(buf, np.asarray(arr), allow_pickle=False)
    return buf.getvalue()


def decode_tile(data: bytes) -> np.ndarray:
    """Inverse of `encode_tile`: ``.npy`` bytes back to the tile array."""
    return np.load(io.BytesIO(data), allow_pickle=False)


def tile_digest(arr: np.ndarray) -> str:
    """Content hash of a tile: sha256 over dtype + shape + exact bytes."""
    a = np.ascontiguousarray(arr)
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(np.asarray(a.shape, np.int64).tobytes())
    h.update(a.tobytes())
    return h.hexdigest()


def config_digest(cfg: DifetConfig, use_kernels: bool = True) -> str:
    """Digest of every extraction-relevant config field (+ route flag):
    part of the cache key, so a config change is always a cache miss."""
    payload = json.dumps({**dataclasses.asdict(cfg),
                          "use_kernels": bool(use_kernels)}, sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


# ---- request / response model ---------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Service knobs.  ``base`` is the extraction config; its ``tile``
    field is replaced per shape bucket.  ``cache_dir`` (optional) backs
    the in-memory LRU with a shared on-disk tier
    (`serve/cache.py::TieredResultCache`) — fleet replicas pointing at the
    same directory warm each other.  ``use_kernels`` takes the CUDA
    kernels (their plain twins on the CPU); ``device`` None means the
    card, ``"cpu"`` runs every step eagerly on the CPU."""
    base: DifetConfig = DifetConfig(tile=64, halo=16,
                                    max_keypoints_per_tile=128)
    buckets: Tuple[int, ...] = (32, 64, 128, 256)
    max_batch: int = 8
    max_batch_delay_s: float = 0.002      # latency/throughput knob
    max_pending: int = 1024               # backpressure knob
    cache_entries: int = 4096             # 0 disables the result cache
    cache_dir: Optional[str] = None       # shared disk tier (fleet mode)
    use_kernels: bool = True
    device: Optional[str] = None          # None = the CUDA card


@dataclasses.dataclass
class ExtractResponse:
    """What a client gets back: per-algorithm features + timing metadata.

    ``results[alg]`` holds the per-request reduced features
    (``total_count``, ``top_ys/top_xs/top_scores/top_valid``,
    ``top_desc`` for descriptor algorithms, …) as read-only numpy arrays;
    multi-tile scene requests are merged across their tiles with the same
    reduce the batch job uses (`core/job.py::DifetJob._merge`)."""
    request_id: str
    algorithms: Tuple[str, ...]
    results: Dict[str, Dict[str, np.ndarray]]
    n_tiles: int
    bucket: int
    cached: Dict[str, float]       # per algorithm: fraction of tiles cached
    timing: Dict[str, object]      # enqueued_at/completed_at/latency_s/...

    @property
    def fully_cached(self) -> bool:
        """True iff every (tile, algorithm) of this request was served
        from the result cache — the device was never touched."""
        return all(v >= 1.0 for v in self.cached.values())


class _TilePart:
    """One bucket tile of a request: cached per-algorithm results plus an
    optional future for the algorithms that still need the device."""

    def __init__(self, cached: Dict[str, Dict[str, np.ndarray]],
                 missing: Tuple[str, ...], future):
        self.cached = cached
        self.missing = missing
        self.future = future


class ResponseHandle:
    """Deferred response: ``result()`` blocks until every tile of the
    request has been served, then assembles the :class:`ExtractResponse`."""

    def __init__(self, request_id: str,
                 algorithms: Tuple[str, ...], parts: List[_TilePart],
                 bucket: int, enqueued_at: float):
        self.request_id = request_id
        self.algorithms = algorithms
        self._parts = parts
        self._bucket = bucket
        self._enqueued_at = enqueued_at

    def done(self) -> bool:
        """Non-blocking readiness probe: True once every tile of the
        request has a result (``result()`` will not block)."""
        return all(p.future is None or p.future.done() for p in self._parts)

    def result(self, timeout: Optional[float] = None) -> ExtractResponse:
        """Assemble the response; ``timeout`` is a total deadline across
        every tile of the request, not per tile.

        ``timing["completed_at"]`` is when the request's *work* finished —
        the latest device-batch completion stamp across its tiles (a
        fully-cached request completes at submit time) — NOT when
        ``result()`` happened to be called.  An open-loop client that
        drains handles in submit order therefore measures true service
        latency, not its own drain position (``latency_s`` used to be
        inflated by exactly that drain wait)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        per_tile: List[Dict[str, Dict[str, np.ndarray]]] = []
        batch_sizes: List[int] = []
        completed_at = self._enqueued_at       # fully-cached: no device wait
        for p in self._parts:
            if p.future is None:
                per_tile.append(dict(p.cached))
                continue
            rem = None if deadline is None else deadline - time.monotonic()
            computed, batch_size, part_done = p.future.result(rem)
            batch_sizes.append(batch_size)
            completed_at = max(completed_at, part_done)
            if not p.cached:
                per_tile.append(computed)
                continue
            tile_res = dict(p.cached)
            for alg in p.missing:
                tile_res[alg] = computed[alg]
            per_tile.append(tile_res)
        if len(per_tile) == 1:
            results = {alg: per_tile[0][alg] for alg in self.algorithms}
        else:
            results = {alg: DifetJob._merge([t[alg] for t in per_tile])
                       for alg in self.algorithms}
        cached = {alg: sum(1.0 for p in self._parts if alg not in p.missing)
                  / len(self._parts) for alg in self.algorithms}
        return ExtractResponse(
            request_id=self.request_id, algorithms=self.algorithms,
            results=results, n_tiles=len(self._parts), bucket=self._bucket,
            cached=cached,
            timing={"enqueued_at": self._enqueued_at,
                    "completed_at": completed_at,
                    "latency_s": completed_at - self._enqueued_at,
                    "batch_sizes": tuple(batch_sizes)})


# ---- the service -----------------------------------------------------------

class FeatureService:
    """In-process DIFET feature-extraction service (the unit a fleet of
    workers would replicate behind a load balancer)."""

    def __init__(self, cfg: Optional[ServeConfig] = None, *,
                 name: str = "difet-serve",
                 step_lock: Optional[threading.Lock] = None):
        self.cfg = cfg or ServeConfig()
        self.name = name
        self.table = BucketTable(self.cfg.buckets, self.cfg.base)
        self.compile_cache = CompileCache(self.table, self.cfg.max_batch,
                                          self.cfg.use_kernels,
                                          self.cfg.device)
        if self.cfg.cache_dir:
            self.cache = TieredResultCache(self.cfg.cache_entries,
                                           self.cfg.cache_dir)
        else:
            self.cache = ResultCache(self.cfg.cache_entries)
        # benchmark hook: a lock shared across replicas serializes device
        # steps, so per-replica ``busy_s`` is uncontended wall time and a
        # fleet makespan on a shared CI host is the straggler's busy time
        # (the table1 simulated-worker idiom) — None in production
        self._step_lock = step_lock
        self.busy_s = 0.0                 # runner-thread-only accumulator
        self.steps = 0
        # process-wide per-layer histograms (obs/export.py breakdown
        # table aggregates across replicas); handles cached here so the
        # runner's per-item path is one bounded observe, no registry lock
        _reg = obs_metrics.registry()
        self._m_queue_s = _reg.histogram("difet.scheduler.queue_s")
        self._m_step_s = _reg.histogram("difet.kernel.step_s")
        self.requests = 0                 # accepted submit() calls
        self.shed = 0                     # submit() calls shed on overload
        self.scheduler = BatchScheduler(
            self._run_batch, max_batch=self.cfg.max_batch,
            max_batch_delay_s=self.cfg.max_batch_delay_s,
            max_pending=self.cfg.max_pending, name=name)
        self._lock = threading.Lock()
        self._inflight: Dict[tuple, object] = {}
        self._canvases: Dict[int, tuple] = {}
        self._cfg_digests: Dict[int, str] = {}
        self._scenes: Dict[str, np.ndarray] = {}
        self._req_counter = 0

    # -- config/scene plumbing ----------------------------------------------
    def _cfg_digest(self, bucket: int) -> str:
        if bucket not in self._cfg_digests:
            self._cfg_digests[bucket] = config_digest(
                self.table.cfg_for(bucket), self.cfg.use_kernels)
        return self._cfg_digests[bucket]

    def register_scene(self, name: str, image: np.ndarray) -> None:
        """Make ``submit(name, ...)`` work by scene id."""
        self._scenes[name] = np.asarray(image)

    def _resolve(self, image) -> np.ndarray:
        if isinstance(image, str):
            if image not in self._scenes:
                raise KeyError(f"unknown scene id {image!r} "
                               f"(registered: {sorted(self._scenes)})")
            image = self._scenes[image]
        elif isinstance(image, (bytes, bytearray)):
            image = decode_tile(bytes(image))
        arr = np.asarray(image)
        if arr.ndim == 3:
            return rgba_to_gray(arr)
        if arr.dtype == np.uint8:
            return arr.astype(np.float32) / 255.0
        return np.asarray(arr, np.float32)      # no copy when already f32

    # -- submission ----------------------------------------------------------
    def submit(self, image: Union[np.ndarray, bytes, str], algorithms,
               request_id: Optional[str] = None,
               block: bool = False,
               trace_id: Optional[str] = None) -> ResponseHandle:
        """Enqueue one request.  ``image`` is a grayscale/RGBA array,
        ``.npy`` bytes, or a registered scene id; oversize images are split
        into largest-bucket tiles and merged on completion.  Raises
        :class:`ServiceOverloaded` when the queue is full (``block=True``
        waits instead).  ``trace_id`` ties the request's spans to a
        router-minted trace (`obs/trace.py`); direct callers get one
        minted here when tracing is on."""
        tracing = obs_trace.enabled()
        tid = trace_id or (obs_trace.new_trace_id() if tracing else "")
        algs = normalize_algorithms(algorithms)
        # device/group/coalescing keys use the sorted set (per-algorithm
        # results are order-independent), so permuted algorithm lists share
        # one compiled program, one batch group, and one in-flight entry;
        # the response keeps the request's order
        canonical = tuple(sorted(algs))
        gray = self._resolve(image)
        enqueued_at = time.time()
        with self._lock:
            self._req_counter += 1
            rid = request_id or f"req-{self._req_counter:06d}"
        bucket = self.table.bucket_for(*gray.shape)
        if bucket is None:                      # oversize → multi-tile scene
            bucket = self.table.interiors[-1]
            b = tile_scene(gray, self.table.cfg_for(bucket))
            tiles = [(b.tiles[i], b.headers[i]) for i in range(len(b))]
        else:
            tiles = [self.table.pad_to_bucket(gray, bucket)]
        cfg_dig = self._cfg_digest(bucket)
        # NOTE: a multi-tile submit hitting backpressure mid-loop raises
        # with its earlier tiles already queued; they complete into the
        # result cache, so a retry reuses rather than recomputes them
        try:
            # the ambient trace id lets un-threaded layers underneath
            # (the cache tiers' disk I/O) tag their spans with this
            # request's trace (obs/trace.py contextvar)
            with obs_trace.use_trace(tid):
                parts = [self._submit_tile(tile, header, bucket, canonical,
                                           cfg_dig, block, tid)
                         for tile, header in tiles]
        except ServiceOverloaded:
            with self._lock:
                self.shed += 1
            raise
        with self._lock:
            self.requests += 1
        return ResponseHandle(rid, algs, parts, bucket, enqueued_at)

    def _submit_tile(self, tile, header, bucket, algs, cfg_dig,
                     block, trace_id="") -> _TilePart:
        if self.cache.capacity <= 0:
            # cache disabled: digest/probe/in-flight coalescing can't pay
            # for themselves — straight to the queue (zero-copy responses)
            fut = self.scheduler.submit(tile, header, bucket, algs,
                                        block=block, trace_id=trace_id)
            return _TilePart({}, algs, fut)
        # the key must fold the header's grid position + valid extent:
        # results carry scene-GLOBAL coordinates (ys = ty*tile + ...), so
        # two pixel-identical tiles at different (ty, tx) — e.g. a
        # recurring granule in an oversize scene split — have different
        # correct outputs and must never alias (scene_id itself doesn't
        # enter the compute, so it stays out of the key)
        digest = (tile_digest(tile)
                  + ":" + ",".join(str(int(v)) for v in header[1:]))
        cached = {}
        for alg in algs:
            hit = self.cache.get((digest, alg, cfg_dig))
            if hit is not None:
                cached[alg] = hit
        missing = tuple(a for a in algs if a not in cached)
        if not missing:
            return _TilePart(cached, (), None)
        # coalesce concurrent identical work before queueing new work.
        # scheduler.submit may BLOCK on backpressure, so it must run
        # outside the service lock — a stalled submitter must not wedge
        # every other request.  The tiny race window (two threads both
        # missing the in-flight map) only duplicates work, never corrupts.
        with self._lock:
            fut = self._inflight.get(key := (digest, missing, cfg_dig,
                                             bucket))
        if fut is None:
            fut = self.scheduler.submit(tile, header, bucket, missing,
                                        digest=digest,
                                        cfg_digest=cfg_dig, block=block,
                                        trace_id=trace_id)
            with self._lock:
                if key not in self._inflight:
                    self._inflight[key] = fut
                    fut.add_done_callback(
                        lambda _f, k=key: self._inflight.pop(k, None))
        return _TilePart(cached, missing, fut)

    def extract(self, image, algorithms, timeout: Optional[float] = None,
                block: bool = True) -> ExtractResponse:
        """Synchronous convenience: submit + wait."""
        return self.submit(image, algorithms, block=block).result(timeout)

    # -- device step ---------------------------------------------------------
    def _run_batch(self, bucket: int, algorithms: Tuple[str, ...],
                   items: Sequence[WorkItem]) -> None:
        """Scheduler runner: scatter items into the bucket's fixed-shape
        batch (padded rows carry the pad flag), run the bucket's program
        (one graph replay and one copy back on the card), freeze + cache
        per-item results, resolve futures."""
        if self._step_lock is not None:
            with self._step_lock:
                return self._run_batch_locked(bucket, algorithms, items)
        return self._run_batch_locked(bucket, algorithms, items)

    def _run_batch_locked(self, bucket, algorithms, items) -> None:
        t_start = time.monotonic()
        tracing = obs_trace.enabled()
        if tracing:
            # queue-wait spans: enqueue → batch formation, one per item,
            # carrying the item's trace id (stamps already taken — no
            # extra clock reads on the untraced path)
            for it in items:
                obs_trace.emit_span("queue_wait", "scheduler",
                                    it.enqueued_at, t_start,
                                    trace_id=it.trace_id,
                                    replica=self.name, bucket=bucket)
        # per-bucket scratch canvas (pinned memory on the card), reused
        # across steps: the runner thread is the only writer, and a step
        # has read it by the time it returns.  Rows beyond the batch keep
        # stale-but-finite tile data; their headers are re-marked pad, so
        # the engine masks them out — only the zeroing is skipped.
        canvas = self._canvases.get(bucket)
        if canvas is None:
            canvas = self._canvases[bucket] = \
                self.compile_cache.empty_batch(bucket)
        tiles, headers = canvas
        headers[:, :] = 0
        headers[:, 5] = 1
        for i, it in enumerate(items):
            tiles[i] = it.tile
            headers[i] = it.header
        fn = self.compile_cache.get(bucket, algorithms)
        t_kernel = time.monotonic()
        out = fn(tiles, headers)        # one replay, one host transfer
        t_kernel_done = time.monotonic()
        self._m_step_s.observe(t_kernel_done - t_kernel)
        batch_span = None
        if tracing:
            batch_span = obs_trace.emit_span(
                "device_step", "kernel", t_kernel, t_kernel_done,
                trace_id="", replica=self.name, bucket=bucket,
                batch_size=len(items), algorithms=",".join(algorithms))
        for res in out.values():
            for v in res.values():
                v.setflags(write=False)            # responses are read-only
        caching = self.cache.capacity > 0
        # service-time stamp: the device step for this batch is done NOW.
        # It rides in the future payload so ResponseHandle can report the
        # completion time of the work itself — result() may be called
        # arbitrarily late (an open-loop client draining handles in submit
        # order), and stamping at assembly would bill that drain wait as
        # service latency.
        completed_at = time.time()
        now_mono = time.monotonic()
        for i, it in enumerate(items):
            it.completed_at = completed_at
            dt = now_mono - it.enqueued_at
            self.scheduler.queue_hist.observe(dt)
            self._m_queue_s.observe(dt)
            res = {}
            # ambient trace for the cache tiers' disk-write spans
            with obs_trace.use_trace(it.trace_id):
                for alg in algorithms:
                    sliced = {k: v[i] for k, v in out[alg].items()}
                    if caching:
                        # freeze = an owned copy, so a cache entry never
                        # pins the whole batch buffer it was sliced from
                        sliced = self.cache.put(
                            (it.digest, alg, it.cfg_digest), sliced)
                    res[alg] = sliced
            if tracing:
                obs_trace.emit_span("exec", "batch", t_kernel, now_mono,
                                    trace_id=it.trace_id,
                                    parent_id=batch_span or "",
                                    replica=self.name, bucket=bucket,
                                    batch_size=len(items))
            # first-wins settle: a concurrent kill() may have failed this
            # item already (serve/scheduler.py::WorkItem.resolve)
            it.resolve((res, it.batch_size, completed_at))
        self.busy_s += time.monotonic() - t_start
        self.steps += 1

    # -- ops -----------------------------------------------------------------
    def warmup(self, algorithm_sets: Sequence,
               buckets: Optional[Sequence[int]] = None) -> int:
        """Pre-build every (bucket, algorithm-set) program (on the card:
        capture its graph; see `serve/buckets.py::warmup`).  Call before
        taking traffic."""
        sets = [tuple(sorted(normalize_algorithms(a)))
                for a in algorithm_sets]
        return warmup(self.compile_cache, sets, buckets)

    def stats(self) -> Dict[str, object]:
        """Operational counters, cheap enough for an autoscaler to poll:
        nested result-cache / scheduler detail plus a flat per-replica
        snapshot (``submitted``/``shed`` requests, cache hit/miss, batch
        occupancy, p50/p99 queue latency, device busy seconds) that
        `serve/router.py::Router.stats` aggregates across the fleet."""
        sched = self.scheduler.stats()
        cache = self.cache.stats()
        return {"cache": cache,
                "scheduler": sched,
                "programs": self.compile_cache.programs,
                "program_keys": self.compile_cache.keys(),
                # flat per-replica counters (the fleet aggregation surface)
                "name": self.name,
                "submitted": self.requests,
                "shed": self.shed,
                "cache_hits": cache["hits"],
                "cache_misses": cache["misses"],
                "queue_depth": sched["queue_depth"],
                "batches": sched["batches"],
                "batch_occupancy": sched["occupancy"],
                "p50_queue_ms": sched["p50_queue_ms"],
                "p99_queue_ms": sched["p99_queue_ms"],
                "busy_s": self.busy_s,
                "steps": self.steps}

    def drain(self, timeout: Optional[float] = 30.0) -> None:
        """Stop accepting work and process everything already queued:
        new ``submit`` calls raise :class:`ServiceClosed`, every accepted
        item's future resolves (zero dropped responses), then the runner
        thread exits.  The drain half of the fleet's drain → retire
        lifecycle (`serve/fleet.py`)."""
        self.scheduler.stop(timeout)

    def kill(self, exc: Optional[BaseException] = None) -> None:
        """Chaos hook: crash the replica *without* draining — queued and
        on-device items fail with :class:`serve.scheduler.ReplicaDied` so
        a router can re-admit them (`serve/router.py::Router`)."""
        self.scheduler.kill(exc)

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Drain and stop the scheduler runner thread (idempotent);
        pending futures resolve before shutdown or time out."""
        self.scheduler.stop(timeout)
