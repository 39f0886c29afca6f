"""Cross-process replica worker + its parent-side client.

Port of ``repro/serve/proc.py``.  Thread replicas share one process, so
crash re-admission and cache partitions there are simulated.  This
module makes the replica an OS process, so ``kill -9`` is a *real*
SIGKILL and the only surviving channels are the ones the paper's
architecture actually grants a distributed worker: the spooled-file
transport (`serve/transport.py`), `LeaseBoard` lease files as the
liveness heartbeat, and the shared `DiskCacheTier`.

A worker runs where its ``ServeConfig.device`` says: ``None`` is the
card, where it holds a CUDA context, graph pool and pinned canvases of
its own (workers on one card time-slice it).  Without a card such a
worker raises before it publishes its ready marker, and
:meth:`ProcReplicaClient.wait_ready` reports its log.  Its ready marker
names the kernels captured into its graphs
(`kernels/ops.py::launch_counts`, which tick at capture) and its
``torch.cuda.memory_reserved``.  The parent builds the kernel libraries
before it spawns a worker for the card (`kernels/build.py::build_all`),
so no worker runs ``nvcc``.

Two halves:

* :func:`run_worker` / ``python -m repro_torch.serve.proc`` — the worker
  process.  It builds a normal in-process `FeatureService`, warms the
  requested programs (captures their graphs on the card), publishes a
  ready marker, then loops:
  heartbeat its own lease, claim requests from the mailbox, submit them
  to the service, publish responses (response file = commit point),
  republish stats, honour the drain flag.  Every loop iteration re-reads
  the mailbox's chaos plan (`serve/chaos.py`), so tests steer faults —
  stalled heartbeats, withheld responses, self-``kill -9`` — in-band.
* :class:`ProcReplicaClient` — the router-facing proxy.  It duck-types
  the slice of `FeatureService` that `serve/router.py` and
  `serve/fleet.py` touch (``submit``/``stats``/``register_scene``/
  ``drain``/``kill``/``warmup`` plus ``scheduler.queue_depth``), so the
  same `Router`/`Fleet` code drives thread and process replicas.
  :class:`ProcHandle` mirrors `ResponseHandle` and adds ``failed()`` —
  died-without-a-response — which the router's re-admission probe uses.

Liveness is worker-reported: the *worker* refreshes its lease; the
parent never touches it.  A SIGKILL therefore stops the heartbeat at
the same instant it stops the work, and the fleet's maintenance loop
discovers the death the way a distributed control plane would — by the
lease going stale — not by waiting on a child process handle.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.difet_paper import DifetConfig
from repro_torch.core.job import LeaseBoard
from repro_torch.kernels import build, ops
from repro_torch.serve import chaos
from repro_torch.serve.api import (ExtractResponse, FeatureService,
                                   ServeConfig, decode_tile)
from repro_torch.serve.scheduler import ReplicaDied, ServiceClosed
from repro_torch.serve.transport import WorkerMailbox

__all__ = ["ProcReplicaClient", "ProcHandle", "serve_config_to_json",
           "serve_config_from_json", "run_worker"]


# -- config over the wire ----------------------------------------------------

def serve_config_to_json(cfg: ServeConfig) -> Dict[str, object]:
    """`ServeConfig` → JSON-able dict (inverse of
    `serve_config_from_json`; ``use_kernels`` and ``device`` included);
    shipped to the worker as a file."""
    return dataclasses.asdict(cfg)


def serve_config_from_json(d: Dict[str, object]) -> ServeConfig:
    """Rebuild a `ServeConfig` (tuples restored) from
    `serve_config_to_json` output."""
    d = dict(d)
    base = dict(d.pop("base"))
    base["scene_hw"] = tuple(base.get("scene_hw", (7681, 7831)))
    d["buckets"] = tuple(d.get("buckets", ()))
    return ServeConfig(base=DifetConfig(**base), **d)


def _jsonable(v):
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return str(v)


def _encode_response(resp: ExtractResponse) -> Tuple[Dict, Dict]:
    """`ExtractResponse` → (meta, arrays) for the transport; per-
    algorithm arrays are flattened to ``"<alg>/<key>"`` names so the one
    ``.npz`` keeps every leaf bit-exact."""
    arrays = {f"{alg}/{k}": v
              for alg, res in resp.results.items() for k, v in res.items()}
    meta = {"status": "ok",
            "request_id": resp.request_id,
            "algorithms": list(resp.algorithms),
            "n_tiles": int(resp.n_tiles),
            "bucket": int(resp.bucket),
            "cached": {k: float(v) for k, v in resp.cached.items()},
            "timing": _jsonable(resp.timing)}
    return meta, arrays


def _decode_response(meta: Dict, arrays: Dict) -> ExtractResponse:
    results: Dict[str, Dict[str, np.ndarray]] = {}
    for name, arr in arrays.items():
        alg, _, key = name.partition("/")
        results.setdefault(alg, {})[key] = arr
    return ExtractResponse(request_id=meta["request_id"],
                           algorithms=tuple(meta["algorithms"]),
                           results=results,
                           n_tiles=int(meta["n_tiles"]),
                           bucket=int(meta["bucket"]),
                           cached=dict(meta["cached"]),
                           timing=dict(meta["timing"]))


# -- the worker process ------------------------------------------------------

def run_worker(name: str, mailbox_dir: str, lease_dir: str, *,
               lease_ttl_s: float, heartbeat_interval_s: float,
               serve_config_path: str, warm_sets: List[List[str]],
               poll_interval_s: float = 0.003,
               telemetry_interval_s: float = 0.0) -> int:
    """Worker main loop (see module docstring).  Returns the process
    exit code: 0 on a clean drain.  Faults from the mailbox's chaos plan
    are honoured *every* iteration — a live worker can stop
    heartbeating, sit on finished responses, or ``os._exit(137)``
    after its N-th response.

    ``telemetry_interval_s > 0`` turns the fleet telemetry plane on for
    this worker: a `FlightRecorder` is installed (so the scheduler/batch
    spans carry the parent-minted trace ids), and a
    `obs/ship.py::TelemetryShipper` spools metric deltas + span
    batches onto the mailbox's ``telemetry/`` channel once after the
    warm-up and then every interval, with one forced flush on drain so no
    tail telemetry is lost."""
    mbox = WorkerMailbox(mailbox_dir)
    leases = LeaseBoard(lease_dir, ttl_s=lease_ttl_s)
    cfg = serve_config_from_json(
        json.loads(Path(serve_config_path).read_text()))
    shipper = None
    if telemetry_interval_s > 0:
        from repro_torch.obs import trace as obs_trace
        from repro_torch.obs.ship import TelemetryShipper
        dump_dir = os.environ.get("DIFET_CHAOS_DUMP_DIR") \
            or str(mbox.root / "dumps")
        Path(dump_dir).mkdir(parents=True, exist_ok=True)
        obs_trace.set_recorder(
            obs_trace.FlightRecorder(capacity=8192, dump_dir=dump_dir))
        shipper = TelemetryShipper(
            mbox, name, recorder=obs_trace.get_recorder(),
            interval_s=telemetry_interval_s)
    svc = FeatureService(cfg, name=name)
    if warm_sets:
        svc.warmup([tuple(s) for s in warm_sets])
    if shipper is not None:
        # the warm-up's telemetry goes out before traffic: a worker killed
        # before its first interval has still shipped once
        shipper.ship()
    leases.acquire(name, name)
    device = svc.compile_cache.device
    mbox.write_ready({
        "name": name, "pid": os.getpid(),
        "programs": svc.compile_cache.programs, "device": str(device),
        "kernels_captured": ops.launch_counts(),
        "memory_reserved": (torch.cuda.memory_reserved(device)
                            if device.type == "cuda" else 0)})
    pending: Dict[str, object] = {}        # rid -> ResponseHandle
    served = 0
    last_hb = time.time()
    last_stats = 0.0
    while True:
        now = time.time()
        plan = chaos.read_plan(mbox.root)
        if (not plan.heartbeat_stalled(now)
                and now - last_hb >= heartbeat_interval_s):
            leases.acquire(name, name)     # refresh own lease
            last_hb = now
        for rid, meta, arrays in mbox.claim_requests():
            try:
                h = svc.submit(arrays["image"],
                               tuple(meta.get("algorithms", ())),
                               request_id=rid, block=True,
                               trace_id=meta.get("trace_id") or None)
                pending[rid] = h
            except Exception as e:  # noqa: BLE001 — report, don't die
                mbox.send_response(rid, {"status": "error",
                                         "request_id": rid,
                                         "error": repr(e)}, {})
        if not plan.responses_held(now):
            for rid in list(pending):
                h = pending[rid]
                if not h.done():
                    continue
                try:
                    rmeta, rarrays = _encode_response(h.result(10.0))
                except Exception as e:  # noqa: BLE001
                    rmeta, rarrays = {"status": "error", "request_id": rid,
                                      "error": repr(e)}, {}
                mbox.send_response(rid, rmeta, rarrays)
                del pending[rid]
                served += 1
                if (plan.exit_after_requests
                        and served >= plan.exit_after_requests):
                    os._exit(137)          # self-inflicted kill -9
        if now - last_stats >= 0.25:
            mbox.write_stats(_jsonable(svc.stats()))
            last_stats = now
        if shipper is not None:
            shipper.maybe_ship()
        if (mbox.drain_requested() and not pending
                and not mbox.claim_requests()):
            mbox.write_stats(_jsonable(svc.stats()))
            svc.close()
            if shipper is not None:
                shipper.ship(final=True)   # retire flush: no tail loss
            leases.release(name, name)
            return 0
        time.sleep(poll_interval_s)


def _worker_main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.serve.proc")
    ap.add_argument("--name", required=True)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--lease-dir", required=True)
    ap.add_argument("--lease-ttl", type=float, default=5.0)
    ap.add_argument("--heartbeat-interval", type=float, default=0.2)
    ap.add_argument("--serve-config", required=True)
    ap.add_argument("--warm-sets", default="[]")
    ap.add_argument("--poll-interval", type=float, default=0.003)
    ap.add_argument("--telemetry-interval", type=float, default=0.0)
    a = ap.parse_args(argv)
    return run_worker(a.name, a.dir, a.lease_dir,
                      lease_ttl_s=a.lease_ttl,
                      heartbeat_interval_s=a.heartbeat_interval,
                      serve_config_path=a.serve_config,
                      warm_sets=json.loads(a.warm_sets),
                      poll_interval_s=a.poll_interval,
                      telemetry_interval_s=a.telemetry_interval)


# -- parent-side proxy -------------------------------------------------------

class ProcHandle:
    """Parent-side handle for one request to a process replica; mirrors
    `serve/api.py::ResponseHandle` (``done()``/``result()``) and adds
    ``failed()`` for the router's re-admission probe.  The response file
    is checked *before* the dead flag everywhere, so work the replica
    finished before dying is still delivered, never recomputed."""

    def __init__(self, client: "ProcReplicaClient", rid: str):
        self._client = client
        self.request_id = rid
        self._resp: Optional[ExtractResponse] = None

    def _load(self) -> Optional[ExtractResponse]:
        if self._resp is not None:
            return self._resp
        msg = self._client.mailbox.try_read_response(self.request_id)
        if msg is None:
            return None
        meta, arrays = msg
        if meta.get("status") != "ok":
            raise RuntimeError(f"replica {self._client.name} failed "
                               f"{self.request_id}: {meta.get('error')}")
        self._resp = _decode_response(meta, arrays)
        self._client._settled(self.request_id)
        return self._resp

    def done(self) -> bool:
        """True once a response is published (or the replica died)."""
        return (self._resp is not None
                or self._client.mailbox.has_response(self.request_id)
                or self._client.dead.is_set())

    def failed(self) -> bool:
        """Replica died with no response published — the request needs
        re-admission to a survivor."""
        return (self._resp is None
                and self._client.dead.is_set()
                and not self._client.mailbox.has_response(self.request_id))

    @property
    def completed_at(self) -> Optional[float]:
        """Worker-stamped work-finish time (None before the response
        lands) — the fleet's SLO latency histogram reads this."""
        return (None if self._resp is None
                else self._resp.timing.get("completed_at"))

    def result(self, timeout: Optional[float] = None) -> ExtractResponse:
        """Block for the response; raises
        `serve/scheduler.py::ReplicaDied` if the replica died without
        publishing one (a persisted response always wins over death)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            resp = self._load()
            if resp is not None:
                return resp
            if self._client.dead.is_set():
                raise ReplicaDied(
                    f"replica {self._client.name} died before answering "
                    f"{self.request_id}")
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"no response for {self.request_id} after {timeout}s")
            time.sleep(self._client.poll_interval_s)


class _SchedulerView:
    """The one scheduler attribute the router touches on a replica:
    ``queue_depth`` (here: requests sent but not yet answered)."""

    def __init__(self, client: "ProcReplicaClient"):
        self._client = client

    @property
    def queue_depth(self) -> int:
        return self._client.outstanding()


class ProcReplicaClient:
    """Router-facing proxy for one worker process (see module
    docstring).  Construct via :meth:`spawn`, then :meth:`wait_ready`
    before routing traffic."""

    def __init__(self, name: str, root, proc: subprocess.Popen,
                 poll_interval_s: float = 0.002):
        self.name = name
        self.root = Path(root)
        self.proc = proc
        self.poll_interval_s = poll_interval_s
        self.mailbox = WorkerMailbox(self.root)
        self.dead = threading.Event()
        self.scheduler = _SchedulerView(self)
        self._scenes: Dict[str, np.ndarray] = {}
        self._inflight: set = set()
        self._lock = threading.Lock()
        self._rid = 0

    # -- lifecycle -----------------------------------------------------------
    @classmethod
    def spawn(cls, name: str, root, serve_cfg: ServeConfig, lease_dir, *,
              lease_ttl_s: float = 5.0, heartbeat_interval_s: float = 0.2,
              warm_algorithm_sets=(), poll_interval_s: float = 0.002,
              worker_poll_s: float = 0.003,
              telemetry_interval_s: float = 0.0) -> "ProcReplicaClient":
        """Launch the worker process (``python -m repro_torch.serve.proc``)
        with its mailbox under ``root``; returns immediately — pair with
        :meth:`wait_ready`.  stdout/stderr land in
        ``<root>/worker.log``.  A worker for the card finds its kernel
        libraries built: they are built here first."""
        if (serve_cfg.use_kernels
                and torch.device(serve_cfg.device or "cuda").type == "cuda"):
            build.build_all()
        root = Path(root)
        root.mkdir(parents=True, exist_ok=True)
        cfg_path = root / "serve_config.json"
        cfg_path.write_text(json.dumps(serve_config_to_json(serve_cfg)))
        src_dir = Path(__file__).resolve().parent.parent.parent
        env = dict(os.environ)
        env["PYTHONPATH"] = (f"{src_dir}{os.pathsep}{env['PYTHONPATH']}"
                             if env.get("PYTHONPATH") else str(src_dir))
        cmd = [sys.executable, "-m", "repro_torch.serve.proc",
               "--name", name, "--dir", str(root),
               "--lease-dir", str(lease_dir),
               "--lease-ttl", str(lease_ttl_s),
               "--heartbeat-interval", str(heartbeat_interval_s),
               "--serve-config", str(cfg_path),
               "--warm-sets",
               json.dumps([list(s) for s in warm_algorithm_sets]),
               "--poll-interval", str(worker_poll_s),
               "--telemetry-interval", str(telemetry_interval_s)]
        with open(root / "worker.log", "ab") as log:
            proc = subprocess.Popen(cmd, stdout=log,
                                    stderr=subprocess.STDOUT, env=env)
        return cls(name, root, proc, poll_interval_s)

    def wait_ready(self, timeout: float = 120.0) -> Dict[str, object]:
        """Block until the worker publishes its ready marker (warm-up
        complete); raises with the tail of ``worker.log`` if the process
        exits first."""
        deadline = time.monotonic() + timeout
        while True:
            info = self.mailbox.read_ready()
            if info is not None:
                return info
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"worker {self.name} exited rc={self.proc.returncode} "
                    f"before ready:\n{self._log_tail()}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"worker {self.name} not ready "
                                   f"after {timeout}s")
            time.sleep(0.02)

    def _log_tail(self, n: int = 20) -> str:
        try:
            lines = (self.root / "worker.log").read_text().splitlines()
            return "\n".join(lines[-n:])
        except OSError:
            return "<no worker.log>"

    def alive(self) -> bool:
        """Is the worker process itself still running?  (Liveness for
        fleet decisions is the *lease*; this is the process-table
        ground truth used to reap zombies.)"""
        return self.proc.poll() is None

    @property
    def pid(self) -> int:
        """Worker process id (the ``kill -9`` target)."""
        return self.proc.pid

    def mark_dead(self) -> None:
        """Flip every outstanding handle to the died path (persisted
        responses still deliver).  Called by the fleet once the lease
        goes stale, or by :meth:`kill`."""
        self.dead.set()

    def kill(self, exc: Optional[BaseException] = None) -> None:
        """Chaos hook mirroring `FeatureService.kill`: SIGKILL the
        worker and mark it dead — no drain, no cleanup."""
        chaos.sigkill(self.proc.pid)
        try:
            self.proc.wait(timeout=10.0)
        except subprocess.TimeoutExpired:
            pass
        self.mark_dead()

    def drain(self, timeout: Optional[float] = 30.0) -> None:
        """Raise the drain flag and wait for the worker to answer every
        accepted request and exit 0; a worker that overruns ``timeout``
        is killed (and marked dead) rather than leaked."""
        self.mailbox.request_drain()
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.kill()

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Alias for :meth:`drain` (the `FeatureService` surface)."""
        self.drain(timeout)

    # -- the FeatureService surface the router drives ------------------------
    def warmup(self, algorithm_sets, buckets=None) -> int:
        """No-op: the worker warms itself before publishing ready."""
        return 0

    def register_scene(self, name: str, image: np.ndarray) -> None:
        """Scene ids resolve parent-side; requests always ship resolved
        pixel arrays so the worker needs no scene registry."""
        self._scenes[name] = np.asarray(image)

    def _resolve(self, image) -> np.ndarray:
        if isinstance(image, str):
            if image not in self._scenes:
                raise KeyError(f"unknown scene id {image!r}")
            return self._scenes[image]
        if isinstance(image, (bytes, bytearray)):
            return decode_tile(bytes(image))
        return np.asarray(image)

    def submit(self, image, algorithms, request_id: Optional[str] = None,
               block: bool = False,
               trace_id: Optional[str] = None) -> ProcHandle:
        """Publish one request into the worker's mailbox and return a
        :class:`ProcHandle`.  Raises `ServiceClosed` when the replica is
        already known dead (the router's retry path picks a survivor)."""
        if self.dead.is_set():
            raise ServiceClosed(f"replica {self.name} is dead")
        with self._lock:
            self._rid += 1
            rid = request_id or f"{self.name}-r{self._rid:06d}"
            self._inflight.add(rid)
        self.mailbox.send_request(
            rid, {"algorithms": [str(a) for a in algorithms],
                  "trace_id": trace_id or ""},
            {"image": self._resolve(image)})
        return ProcHandle(self, rid)

    def _settled(self, rid: str) -> None:
        with self._lock:
            self._inflight.discard(rid)

    def outstanding(self) -> int:
        """Requests sent but not yet answered (the router's queue-depth
        signal for this replica); prunes answered rids as it scans."""
        with self._lock:
            inflight = list(self._inflight)
        depth = 0
        for rid in inflight:
            if self.mailbox.has_response(rid):
                self._settled(rid)
            else:
                depth += 1
        return depth

    def stats(self) -> Dict[str, object]:
        """The worker's last published ``stats()`` snapshot, with the
        parent-side queue depth (more current than the snapshot) and
        zeroed defaults before the first publish."""
        base = self.mailbox.read_stats() or {}
        out = {"name": self.name, "submitted": 0, "shed": 0,
               "cache_hits": 0, "cache_misses": 0, "batches": 0,
               "batch_occupancy": 0.0, "p50_queue_ms": 0.0,
               "p99_queue_ms": 0.0, "busy_s": 0.0, "steps": 0,
               "cache": {"hits": 0, "misses": 0},
               "scheduler": {}, "programs": 0, "program_keys": []}
        out.update(base)
        out["queue_depth"] = self.outstanding()
        out["pid"] = self.proc.pid
        out["alive"] = self.alive()
        return out


if __name__ == "__main__":
    sys.exit(_worker_main())
