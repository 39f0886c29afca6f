"""Checkpointed, restartable jobs: the Hadoop JobTracker's roles map to:
  * task re-execution on failure  → a JSON manifest with a processed-item
    bitmap; on restart, only missing items are (deterministically)
    re-executed, so re-execution is safe.
  * speculative execution for stragglers → over-decomposition: each bundle
    is split into ``shards_per_bundle`` independent shards.

Port of ``repro/core/job.py``.  ``ManifestJob`` is the generic machinery
(manifest + atomic commit + resume loop + per-worker leases); ``DifetJob``
is the extraction phase over bundles, on the port's engine; the stitching
workload's registration phase (``core/mosaic.py::MatchPhase``) reuses the
same machinery.  With ``mesh=`` each shard of a bundle runs split over
the mesh's devices (`core/engine.py::make_distributed_multi_extractor`,
bit for bit the one-device result; the split may be uneven, so the
reference's padding to the mesh size and its ``_slice_result`` crop have
no counterpart).  Counters (``repro_torch.obs``):
``difet.job.lease_acquires``, ``difet.job.lease_steals`` and
``difet.job.manifest_commits``.

Multi-worker protocol: the manifest's item order is fixed at creation and
never rewritten.  Workers coordinate through ``LeaseBoard``: an item is
claimed by atomically creating a sidecar lease file; a crashed worker's
lease expires after ``ttl_s``.  Processing is deterministic and the result
commit atomic, so a lease race at worst duplicates work.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.difet_paper import DifetConfig
from repro_torch.core.bundle import BundleStore, TileBundle
from repro_torch.core.engine import (extract_features_multi,
                                     make_distributed_multi_extractor)
from repro_torch.distributed.sharding import one_device
from repro_torch.obs import metrics as obs_metrics


class SimulatedFailure(RuntimeError):
    """Raised by ``run(simulate_failure_after=N)`` after N items: the
    fault-tolerance tests' stand-in for a worker that dies."""


@dataclasses.dataclass
class JobManifest:
    """The on-disk job state: ordered work items + their done bitmap.

    ``bundle_names`` is fixed at creation and NEVER rewritten — the
    restart-determinism contract: every restart, and every worker of an
    elastic pool, walks the same ordered list (leases partition it).

    Fields:
        algorithm:         job name (extraction jobs: the algorithm string).
        bundle_names:      work-item names in execution order.
        done:              item name -> committed flag.
        started_at:        epoch seconds at manifest creation.
        shards_per_bundle: over-decomposition factor (straggler bound).
    """
    algorithm: str
    bundle_names: List[str]
    done: Dict[str, bool]
    started_at: float
    shards_per_bundle: int = 4

    def to_json(self) -> str:
        """Serialize for the atomic manifest commit."""
        return json.dumps(dataclasses.asdict(self), indent=1)

    @classmethod
    def from_json(cls, s: str) -> "JobManifest":
        """Parse a manifest previously written by `to_json`."""
        return cls(**json.loads(s))

    @property
    def remaining(self) -> List[str]:
        """Unprocessed item names, in manifest (execution) order."""
        return [b for b in self.bundle_names if not self.done.get(b)]


class LeaseBoard:
    """Per-item worker leases: filesystem claims for elastic worker pools.

    ``acquire(item, worker)`` claims an item by creating
    ``<item>.lease`` with ``O_CREAT | O_EXCL`` — the same cross-process
    atomicity the manifest commit relies on.  A lease older than
    ``ttl_s`` is considered orphaned (its worker died) and is stolen with
    an atomic replace.  Re-acquiring one's own lease refreshes it.

    The board is an *optimization*, not a correctness boundary: item
    processing is deterministic and result commits are atomic, so the
    worst outcome of a steal race is two workers redundantly computing
    the same bit-identical result (MapReduce speculative execution).
    """

    def __init__(self, root, ttl_s: float = 600.0):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.ttl_s = ttl_s

    def _path(self, item: str) -> Path:
        return self.root / f"{item}.lease"

    def _write(self, path: Path, worker: str) -> None:
        # unique tmp per writer (two stealers racing must not consume each
        # other's tmp file; the losing replace just overwrites benignly)
        tmp = path.with_suffix(
            f".tmp.{os.getpid()}.{threading.get_ident()}")
        tmp.write_text(json.dumps({"worker": worker, "t": time.time()}))
        tmp.replace(path)

    def acquire(self, item: str, worker: str) -> bool:
        """Try to claim ``item`` for ``worker``; True on success (including
        refreshing a lease this worker already holds or stealing a stale
        one)."""
        path = self._path(item)
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            try:
                lease = json.loads(path.read_text())
            except (OSError, ValueError):
                lease = None                    # mid-write/corrupt: steal
            if lease is not None:
                if lease.get("worker") == worker:
                    self._write(path, worker)   # refresh our own lease
                    return True
                if time.time() - lease.get("t", 0.0) < self.ttl_s:
                    return False                # live lease held elsewhere
            self._write(path, worker)           # stale/orphaned: steal
            obs_metrics.registry().counter("difet.job.lease_steals").inc()
            return True
        with os.fdopen(fd, "w") as f:
            json.dump({"worker": worker, "t": time.time()}, f)
        obs_metrics.registry().counter("difet.job.lease_acquires").inc()
        return True

    def release(self, item: str, worker: str) -> None:
        """Drop ``worker``'s lease on ``item`` (no-op if not held)."""
        path = self._path(item)
        try:
            if json.loads(path.read_text()).get("worker") == worker:
                path.unlink()
        except (OSError, ValueError):
            pass

    def holder(self, item: str) -> Optional[Tuple[str, float]]:
        """``(worker, age_s)`` of the current lease on ``item``, or None
        if unleased (or the lease file is torn mid-write)."""
        try:
            lease = json.loads(self._path(item).read_text())
            return (lease["worker"], time.time() - lease.get("t", 0.0))
        except (OSError, ValueError, KeyError):
            return None

    def fresh(self, item: str) -> bool:
        """Is ``item`` held by a lease younger than ``ttl_s``?  The
        liveness predicate fleets use: a worker that stops heartbeating
        (re-acquiring its own lease) goes stale after one TTL."""
        h = self.holder(item)
        return h is not None and h[1] < self.ttl_s


class ManifestJob:
    """Checkpointed work queue over named items.

    ``run()`` is restartable: it consults the manifest, processes only
    missing items via ``process(name)`` (subclass hook), and commits the
    manifest write-tmp-then-rename after each item — the MapReduce "task
    commit" analogue.  ``simulate_failure_after`` kills the job after N
    items (used by the fault-tolerance tests).

    ``run(worker_id=...)`` joins an elastic worker pool: items are walked
    in manifest order but claimed through the job's `LeaseBoard`, so any
    number of concurrent workers (or restarts with a *different* worker
    count) partition the remaining work without a coordinator.
    """

    def __init__(self, store: BundleStore, job_name: str,
                 items: Optional[Sequence[str]] = None, manifest_path=None,
                 shards_per_bundle: int = 4, lease_ttl_s: float = 600.0):
        self.store = store
        self.job_name = job_name
        self.manifest_path = Path(manifest_path or
                                  store.root / f"{job_name}.manifest.json")
        self.shards_per_bundle = shards_per_bundle
        self.lease_ttl_s = lease_ttl_s
        self._items = items
        self.manifest = self._load_or_create()

    def _load_or_create(self) -> JobManifest:
        if self.manifest_path.exists():
            return JobManifest.from_json(self.manifest_path.read_text())
        names = (list(self._items) if self._items is not None
                 else self.store.list())
        m = JobManifest(self.job_name, names, {n: False for n in names},
                        time.time(), self.shards_per_bundle)
        self._commit(m)
        return m

    def _commit(self, manifest: JobManifest) -> None:
        # tmp name is unique per writer: concurrent workers committing the
        # same manifest must not consume each other's tmp file mid-replace
        tmp = self.manifest_path.with_suffix(
            f".tmp.{os.getpid()}.{threading.get_ident()}")
        tmp.write_text(manifest.to_json())
        tmp.replace(self.manifest_path)      # atomic manifest update
        obs_metrics.registry().counter("difet.job.manifest_commits").inc()

    def _merge_done_from_disk(self) -> None:
        """OR the on-disk manifest's done map into memory (tolerates a
        concurrent writer; a failed read just keeps the local view)."""
        try:
            disk = JobManifest.from_json(self.manifest_path.read_text())
            for n, d in disk.done.items():
                if d:
                    self.manifest.done[n] = True
        except (OSError, ValueError, TypeError):
            pass

    def _commit_merged(self) -> None:
        """Multi-worker commit: re-read the on-disk manifest and OR the
        done maps before the atomic replace, so concurrent workers don't
        erase each other's marks.  The residual read-replace race only
        drops a *mark*, never a result (results live in the store and are
        re-checked), so a re-run self-heals."""
        self._merge_done_from_disk()
        self._commit(self.manifest)

    @property
    def leases(self) -> LeaseBoard:
        """The job's lease board (sidecar dir next to the manifest)."""
        if not hasattr(self, "_leases"):
            self._leases = LeaseBoard(
                self.manifest_path.with_suffix(".leases"),
                ttl_s=self.lease_ttl_s)
        return self._leases

    def process(self, name: str) -> None:
        """Produce + commit the result for one item (subclass hook)."""
        raise NotImplementedError

    def run(self, simulate_failure_after: Optional[int] = None,
            progress: Optional[Callable[[str], None]] = None,
            worker_id: Optional[str] = None) -> Dict:
        """Process remaining items in manifest order; returns `summary()`.

        Args:
            simulate_failure_after: raise after N items (fault-tolerance
                tests — the restart path is the recovery protocol).
            progress: optional per-item callback with the item name.
            worker_id: join the elastic worker pool under this identity —
                items are claimed via the lease board, skipped when
                another live worker holds them, and released on commit.
                ``None`` (single-worker mode) bypasses leasing entirely.
        """
        processed = 0
        for name in list(self.manifest.remaining):
            if worker_id is not None:
                if self.manifest.done.get(name):
                    continue
                # a peer may have finished this item after our snapshot:
                # one cheap manifest re-read avoids re-extracting a whole
                # bundle (work, not correctness — results are idempotent)
                self._merge_done_from_disk()
                if self.manifest.done.get(name):
                    continue
                if not self.leases.acquire(name, worker_id):
                    continue                    # leased by a live worker
            self.process(name)
            self.manifest.done[name] = True
            if worker_id is not None:
                self._commit_merged()
                self.leases.release(name, worker_id)
            else:
                self._commit(self.manifest)
            processed += 1
            if progress:
                progress(name)
            if simulate_failure_after is not None \
                    and processed >= simulate_failure_after:
                raise SimulatedFailure(
                    f"simulated worker failure after {name}")
        return self.summary()

    def summary(self) -> Dict:
        """Progress report: ``{job, bundles_done, bundles_total}``."""
        done = [n for n, d in self.manifest.done.items() if d]
        return {"job": self.job_name, "bundles_done": len(done),
                "bundles_total": len(self.manifest.bundle_names)}

    # ---- elastic scaling ----------------------------------------------------
    def rebalance(self, n_workers: int) -> List[List[str]]:
        """Partition outstanding items across a (new) worker count —
        called on membership change; returns per-worker work lists."""
        rem = self.manifest.remaining
        return [rem[i::n_workers] for i in range(n_workers)]


class DifetJob(ManifestJob):
    """Checkpointed extraction over a BundleStore, on the port's engine.

    ``algorithm`` may be one name or a comma-separated list
    (``"fast,brief,orb"``): several algorithms go through
    ``extract_features_multi`` so that shared responses are computed once;
    results are stored per algorithm (``<bundle>.<alg>``), as numpy.
    ``use_kernels`` and ``device`` go to the engine (the CUDA card and its
    kernels unless told otherwise).  ``mesh`` (a
    `distributed/sharding.py::Mesh`) splits each shard over its devices
    instead of running it on ``device``; the results are the same bits.
    A mesh of one entry runs the one-device code on its device."""

    def __init__(self, store: BundleStore, algorithm: str,
                 manifest_path=None, shards_per_bundle: int = 4,
                 extractor: Optional[Callable] = None,
                 use_kernels: bool = True, device=None,
                 lease_ttl_s: float = 600.0, mesh=None):
        mesh, device = one_device(mesh, device)
        # a custom extractor's output is opaque: store it under the full
        # job name rather than splitting into per-algorithm results
        if extractor is not None:
            self.algorithms = (algorithm,)
        else:
            self.algorithms = tuple(a.strip() for a in algorithm.split(",")
                                    if a.strip())
            algorithm = ",".join(self.algorithms)   # normalized whitespace
        self.algorithm = algorithm
        self.extractor = extractor
        self.use_kernels = use_kernels
        self.device = device
        self.mesh = mesh
        self._sharded_fns: Dict[DifetConfig, Callable] = {}
        super().__init__(store, algorithm, manifest_path=manifest_path,
                         shards_per_bundle=shards_per_bundle,
                         lease_ttl_s=lease_ttl_s)

    def _shards(self, bundle: TileBundle) -> List[TileBundle]:
        """Over-decomposition for straggler mitigation: split tiles into
        independent shards so slow/failed work is bounded per shard."""
        n = max(1, min(self.shards_per_bundle, len(bundle)))
        splits = np.array_split(np.arange(len(bundle)), n)
        return [TileBundle(bundle.tiles[s], bundle.headers[s], bundle.cfg)
                for s in splits if len(s)]

    def _sharded_fn(self, cfg: DifetConfig) -> Callable:
        """One mesh extractor (its streams) per configuration; the
        algorithms are the job's."""
        if cfg not in self._sharded_fns:
            self._sharded_fns[cfg] = make_distributed_multi_extractor(
                self.algorithms, cfg, self.mesh, self.use_kernels)
        return self._sharded_fns[cfg]

    def _extract(self, tiles, headers, cfg) -> Dict[str, Dict]:
        if self.extractor is not None:
            return {self.algorithm: self.extractor(tiles, headers)}
        if self.mesh is not None:
            return self._sharded_fn(cfg)(tiles, headers)
        return extract_features_multi(tiles, headers, self.algorithms, cfg,
                                      use_kernels=self.use_kernels,
                                      device=self.device)

    def process(self, name: str) -> None:
        """Extract one bundle: split into shards, extract each, merge the
        shard partials, and commit one ``<name>.<algorithm>`` result per
        algorithm to the store."""
        bundle = self.store.get(name)
        partials: Dict[str, List[Dict]] = {}
        for shard in self._shards(bundle):
            r = self._extract(shard.tiles, shard.headers, bundle.cfg)
            for alg, res in r.items():
                partials.setdefault(alg, []).append(
                    {k: _to_numpy(v) for k, v in res.items()})
        for alg, parts in partials.items():
            self.store.put_result(f"{name}.{alg}", self._merge(parts))

    @staticmethod
    def _merge(partials: List[Dict]) -> Dict:
        """The reduce across shards: counts add; top-K re-merges by score."""
        out = {"total_count": np.sum([p["total_count"] for p in partials]),
               "keypoint_count": np.sum([p["keypoint_count"]
                                         for p in partials])}
        scores = np.concatenate([p["top_scores"] for p in partials])
        order = np.argsort(-scores, kind="stable")[:partials[0]["top_scores"].shape[0]]
        out["top_scores"] = scores[order]
        for key in ("top_ys", "top_xs", "top_valid", "top_desc"):
            if key in partials[0]:
                cat = np.concatenate([p[key] for p in partials])
                out[key] = cat[order]
        out["per_tile_count"] = np.concatenate(
            [p["per_tile_count"] for p in partials])
        return out

    def _alg_counts(self, done: List[str], alg: str) -> Dict[str, int]:
        return {n: int(self.store.get_result(f"{n}.{alg}")["total_count"])
                for n in done}

    def summary(self) -> Dict:
        """Progress + feature counts: per-bundle ``counts`` and the
        ``grand_total`` for single-algorithm jobs; the same nested under
        ``per_algorithm`` for multi-algorithm jobs."""
        done = [n for n, d in self.manifest.done.items() if d]
        base = {"algorithm": self.algorithm, "bundles_done": len(done),
                "bundles_total": len(self.manifest.bundle_names)}
        if len(self.algorithms) == 1:
            counts = self._alg_counts(done, self.algorithm)
            return {**base, "counts": counts,
                    "grand_total": sum(counts.values())}
        per_alg = {}
        for alg in self.algorithms:
            counts = self._alg_counts(done, alg)
            per_alg[alg] = {"counts": counts,
                            "grand_total": sum(counts.values())}
        return {**base, "per_algorithm": per_alg,
                "grand_total": sum(p["grand_total"]
                                   for p in per_alg.values())}


def _to_numpy(v):
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
