"""Content-hash result caches for the feature service: in-process LRU +
a shared on-disk tier for fleets.

LandSat tiles recur across scenes and across requests (overlapping scene
footprints, re-submitted work, mosaics sharing source granules), and
feature extraction is deterministic — so repeated extraction is pure
waste.  The cache is keyed by ``(tile_digest, algorithm, config_digest)``
(`serve/api.py::tile_digest` / `config_digest`):

* the tile digest hashes the exact padded pixel bytes + shape + dtype, so
  any content change is a miss;
* the algorithm is part of the key, so one tile's SIFT and FAST results
  are independent entries (a request for a superset of algorithms reuses
  the per-algorithm entries it already has);
* the config digest folds every ``DifetConfig`` field plus the
  ``use_pallas`` flag, so a threshold/geometry/backend change can never
  alias a stale result (collision-safety is tested).

Values are per-request feature dicts (numpy leaves) frozen read-only on
insert: cache hits hand out the stored arrays without copying, and the
freeze guarantees no consumer can corrupt a shared entry.

Fleets layer the tiers (`TieredResultCache`): each replica keeps its own
in-memory LRU, backed by one ``DiskCacheTier`` directory shared by every
replica — a write-through on any replica warms the whole fleet, and a
local miss that hits disk is promoted into the local LRU.  Disk entries
are ``.npz`` files named by the sha256 of the cache key, written
tmp-then-rename (the same atomicity `core/job.py` relies on), so
concurrent replica writers never expose a torn entry, and the round trip
is bit-exact (``np.savez`` preserves dtype/shape, 0-d leaves included).
"""
from __future__ import annotations

import hashlib
import io
import os
import threading
import time
import zipfile
from collections import OrderedDict
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


def freeze(tree: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Own + freeze a feature dict: contiguous copies (detached from any
    batch buffer the scheduler will reuse) marked non-writeable."""
    out = {}
    for k, v in tree.items():
        # NOT ascontiguousarray: that silently promotes 0-d leaves
        # (total_count, keypoint_count) to shape (1,)
        a = np.array(v, order="C")       # always an owned copy
        a.setflags(write=False)
        out[k] = a
    return out


class ResultCache:
    """Thread-safe LRU over feature-result dicts.

    ``capacity`` counts entries (one per (tile, algorithm, config) key);
    0 disables the cache entirely (every get is a miss, puts are dropped)
    — the throughput benchmark uses that to measure honest batching wins.
    """

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._d: "OrderedDict[tuple, Dict[str, np.ndarray]]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.inserts = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def get(self, key) -> Optional[Dict[str, np.ndarray]]:
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                self.hits += 1
                return self._d[key]
            self.misses += 1
            return None

    def put(self, key, value: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Insert (refreshing recency) and return the frozen stored value."""
        frozen = freeze(value)
        if self.capacity <= 0:
            return frozen
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
            self._d[key] = frozen
            self.inserts += 1
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)      # evict least-recently-used
                self.evictions += 1
            return frozen

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def keys(self):
        with self._lock:
            return list(self._d)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {"entries": len(self._d), "capacity": self.capacity,
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "inserts": self.inserts,
                    "hit_rate": self.hit_rate}


class DiskCacheTier:
    """Shared on-disk result tier: one directory, one ``.npz`` per cache
    key (filename = sha256 of the key tuple, two-level fan-out so huge
    fleets don't make one giant directory).

    Writes are tmp-then-atomic-rename with a per-writer tmp name, so any
    number of replica processes/threads can write concurrently; a reader
    either sees a complete entry or none.  A corrupt/truncated file (a
    crashed writer on a non-atomic filesystem) reads as a miss and is
    removed.  Values round-trip bit-exactly: dtype, shape and 0-d leaves
    are preserved, and loaded arrays come back frozen read-only."""

    def __init__(self, root):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.errors = 0            # failed writes (partitioned/full disk)
        self._lock = threading.Lock()
        # disk-tier I/O latency histograms (bounded; shared across every
        # tier instance so the per-run breakdown aggregates the fleet)
        _reg = obs_metrics.registry()
        self._m_read_s = _reg.histogram("difet.cache.disk_read_s")
        self._m_write_s = _reg.histogram("difet.cache.disk_write_s")
        self._m_hits = _reg.counter("difet.cache.disk_hits")
        self._m_misses = _reg.counter("difet.cache.disk_misses")
        self._m_errors = _reg.counter("difet.cache.disk_errors")

    def path_for(self, key) -> Path:
        """Deterministic entry path for a cache key (any tuple of
        str/bytes-able parts)."""
        h = hashlib.sha256(repr(key).encode()).hexdigest()
        return self.root / h[:2] / f"{h[2:]}.npz"

    def get(self, key) -> Optional[Dict[str, np.ndarray]]:
        """Load + freeze the entry, or None (miss / torn entry)."""
        path = self.path_for(key)
        t0 = time.monotonic()
        try:
            raw = path.read_bytes()
            with np.load(io.BytesIO(raw), allow_pickle=False) as z:
                out = {}
                for k in z.files:
                    a = z[k]
                    if k.endswith("__0d"):      # un-promote 0-d leaves
                        k, a = k[:-4], a.reshape(())
                    a.setflags(write=False)
                    out[k] = a
        except FileNotFoundError:
            with self._lock:
                self.misses += 1
            self._m_misses.inc()
            return None
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            try:
                path.unlink()                   # torn entry: drop + miss
            except OSError:
                pass
            with self._lock:
                self.misses += 1
            self._m_misses.inc()
            return None
        t1 = time.monotonic()
        with self._lock:
            self.hits += 1
        self._m_hits.inc()
        self._m_read_s.observe(t1 - t0)
        if obs_trace.enabled():                 # ambient trace id (if any)
            obs_trace.emit_span("disk_get", "cache", t0, t1,
                                bytes=len(raw))
        return out

    def put(self, key, value: Dict[str, np.ndarray]) -> None:
        """Write-through one frozen feature dict (atomic rename).

        A failed write — partitioned/unwritable directory, full disk —
        is *absorbed*, not raised: the tier is a performance layer, and
        a replica that can't reach it must degrade to recomputing, never
        crash mid-request (the cache-partition chaos test drives this).
        Failures count in ``errors`` / ``difet.cache.disk_errors``."""
        t0 = time.monotonic()
        path = self.path_for(key)
        buf = io.BytesIO()
        # savez silently promotes 0-d arrays on round trip via indexing
        # conventions elsewhere; tag them so get() restores exact shape
        np.savez(buf, **{(k + "__0d" if np.ndim(v) == 0 else k):
                         np.asarray(v) for k, v in value.items()})
        tmp = path.with_suffix(
            f".tmp.{os.getpid()}.{threading.get_ident()}")
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp.write_bytes(buf.getvalue())
            tmp.replace(path)
        except OSError:
            with self._lock:
                self.errors += 1
            self._m_errors.inc()
            try:
                tmp.unlink()                    # never leave a torn tmp
            except OSError:
                pass
            return
        with self._lock:
            self.inserts += 1
        t1 = time.monotonic()
        self._m_write_s.observe(t1 - t0)
        if obs_trace.enabled():
            obs_trace.emit_span("disk_put", "cache", t0, t1,
                                bytes=buf.getbuffer().nbytes)

    def __len__(self) -> int:
        return sum(1 for _ in self.root.glob("*/*.npz"))

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "inserts": self.inserts, "errors": self.errors}


class TieredResultCache:
    """Per-replica LRU backed by a shared :class:`DiskCacheTier`.

    ``get`` probes the local LRU first, then the disk tier (a disk hit is
    promoted into the LRU so the replica's next probe is memory-speed);
    ``put`` inserts locally and writes through to disk — so one replica's
    computation warms every replica sharing the directory.  Duck-types
    :class:`ResultCache` (``get``/``put``/``capacity``/``stats``…), so
    `serve/api.py::FeatureService` uses either interchangeably."""

    def __init__(self, capacity: int, root):
        self.local = ResultCache(capacity)
        self.disk = DiskCacheTier(root)

    @property
    def capacity(self) -> int:
        return self.local.capacity

    @property
    def hits(self) -> int:
        """Total hits across tiers (local + disk-promoted)."""
        return self.local.hits + self.disk.hits

    @property
    def misses(self) -> int:
        """True fleet-level misses: missed locally AND on disk."""
        return self.disk.misses

    def __len__(self) -> int:
        return len(self.local)

    def get(self, key) -> Optional[Dict[str, np.ndarray]]:
        hit = self.local.get(key)
        if hit is not None:
            return hit
        hit = self.disk.get(key)
        if hit is not None:
            return self.local.put(key, hit)     # promote (re-frozen copy)
        return None

    def put(self, key, value: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        frozen = self.local.put(key, value)
        self.disk.put(key, frozen)
        return frozen

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def keys(self):
        return self.local.keys()

    def stats(self) -> Dict[str, float]:
        s = self.local.stats()
        d = self.disk.stats()
        s["local_misses"] = s["misses"]
        s["misses"] = d["misses"]             # fleet-level miss definition
        s["disk_hits"] = d["hits"]
        s["disk_inserts"] = d["inserts"]
        s["hit_rate"] = self.hit_rate
        return s
