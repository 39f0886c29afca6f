"""Measured matcher dispatch: measure once per shape bucket, route every
later call to the winning implementation.  Port of
``repro/kernels/dispatch.py``.

The fastest formulation of the matcher depends on the device and the shape:
one [Q, K] block of library calls, a loop over database chunks, or the
matcher kernel with or without its database segments.  ``ops.match_best2``
asks :func:`choose_path`, which runs a short microbenchmark per ``(metric,
backend, shape bucket)`` the first time a bucket is seen, keeps the verdict
in memory and in a small JSON file, and answers from memory afterwards.

Buckets round (nq, nk) up to powers of two (the descriptor width stays
exact), so the measurement cost is O(log^2) in shape space.  Probe arrays are
capped (`PROBE_NQ_CAP` / `PROBE_NK_CAP`): beyond the cap every candidate is
linear in the same streamed dimension, so the capped contest ranks them
without a million-row probe.

Candidate paths (`kernels/matcher.py` holds the implementations):

====================  =======================================================
``torch_full``        one [Q, K] distance block (`best2_full`)
``torch_stream``      a loop over database chunks, carried best/second
                      (`best2_stream`)
``cuda_resident``     the matcher kernel with one segment: each query tile's
                      block scans the whole database, no merge (the
                      reference's ``match_kernel``); CUDA tensors only
``cuda_stream``       the same kernel cut into ``matcher.plan``'s segments,
                      merged by the last block of a tile (the reference's
                      ``stream_kernel``); CUDA tensors only
====================  =======================================================

The backend is the tensors' device type, ``cuda`` or ``cpu`` (the
reference's ``tpu`` maps to ``cuda``).  On ``cuda`` the measured default
holds the kernel's two plans only: the card takes a torch formulation only
where the caller asks for one (``use_kernels=False`` or a pinned path),
where the reference lets its jnp paths compete on the TPU.  Of the two
plans, the one ``matcher.plan`` configures (`DEFAULT_PATH`) keeps a bucket
unless the other is faster by more than `SWITCH_MARGIN`.  Databases larger
than `FULL_MAX_ROWS` drop the materializing candidates (``torch_full`` /
``cuda_resident``) outright, as the reference's do.  The reference's VMEM
rule for its resident kernel (``matcher_fits_vmem``) is a TPU budget and is
not copied: on ``cuda`` both kernel plans compete up to `FULL_MAX_ROWS`.

The cache file lives at ``$DIFET_TORCH_DISPATCH_CACHE`` (default
``~/.cache/difet/matcher_dispatch_torch.json``), apart from the reference's,
with entries of the reference's fields; delete it to re-measure, e.g. after
a driver or PyTorch upgrade.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import profile as obs_profile

TORCH_PATHS = ("torch_full", "torch_stream")
CUDA_PATHS = ("cuda_resident", "cuda_stream")
MATCH_PATHS = TORCH_PATHS + CUDA_PATHS

# beyond this many DB rows the [Q, K] block / one-segment candidates are
# excluded (memory hazard, and a lone block per query tile), leaving only
# the streaming paths
FULL_MAX_ROWS = 1 << 17
# probe-array caps: the microbenchmark never materializes more than this
PROBE_NQ_CAP = 512
PROBE_NK_CAP = 1 << 14
_PROBE_REPS = 3
# the launch ``matcher.plan`` configures keeps its bucket unless the other
# candidate is faster by more than this factor.  The probes' rows are all
# valid and timed by the host clock; on an H100 below ~512 rows the two
# kernel plans sat within 1.07-1.27x of each other, at a synchronized call's
# 45-80 us, and their order flipped from run to run
DEFAULT_PATH = "cuda_stream"
SWITCH_MARGIN = 1.5

CACHE_ENV = "DIFET_TORCH_DISPATCH_CACHE"
_ABBREV = {"torch_full": "tf", "torch_stream": "ts",
           "cuda_resident": "cr", "cuda_stream": "cs"}
_lock = threading.Lock()
_memory: Dict[str, str] = {}        # bucket key -> chosen path (per process)
# measurement counter, exposed for tests asserting cache hit/miss behavior
measure_count = 0


def cache_path() -> str:
    """Location of the on-disk dispatch cache (``$DIFET_TORCH_DISPATCH_CACHE``
    or ``~/.cache/difet/matcher_dispatch_torch.json``)."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "difet",
                        "matcher_dispatch_torch.json")


def clear_memory_cache() -> None:
    """Drop the in-process bucket->path memo (the disk cache survives);
    mainly for tests that repoint ``$DIFET_TORCH_DISPATCH_CACHE``."""
    with _lock:
        _memory.clear()


def _load_disk() -> Dict[str, dict]:
    try:
        with open(cache_path()) as f:
            d = json.load(f)
        return d if isinstance(d, dict) else {}
    except (OSError, ValueError):
        return {}


def _store_disk(key: str, entry: dict) -> None:
    path = cache_path()
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        d = _load_disk()
        d[key] = entry
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(d, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass                    # read-only FS: in-memory memo still works


def _pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


def shape_bucket(nq: int, nk: int, d: int) -> Tuple[int, int, int]:
    """Round (nq, nk) up to powers of two; descriptor width stays exact.
    All shapes in a bucket share one measured verdict."""
    return _pow2(max(nq, 1)), _pow2(max(nk, 1)), int(d)


def bucket_key(metric: str, backend: str, nq: int, nk: int, d: int) -> str:
    qb, kb, db = shape_bucket(nq, nk, d)
    return f"{metric}|{backend}|q{qb}|k{kb}|d{db}"


def candidate_paths(metric: str, backend: str, nk: int, d: int,
                    use_kernels: Optional[bool] = None) -> Tuple[str, ...]:
    """Paths eligible for a (metric, backend, DB-size) combination.

    ``use_kernels=True`` restricts to the kernel's plans, ``False`` to the
    torch formulations, ``None`` lets the benchmark decide among the
    backend's own: the kernel's two plans on ``cuda``, the torch
    formulations on the CPU.  ``use_kernels=True`` on the CPU takes
    ``cuda_stream``, whose wrapper runs its plain twin there; the
    materializing candidates drop out beyond `FULL_MAX_ROWS`.  ``metric``
    and ``d`` are the reference's arguments: no rule here reads them (a
    width the kernel does not take raises in its probe,
    ``matcher.check_shapes``).
    """
    del metric, d
    big_db = nk > FULL_MAX_ROWS
    if use_kernels is False or (use_kernels is None and backend != "cuda"):
        return ("torch_stream",) if big_db else TORCH_PATHS
    if backend != "cuda":
        return ("cuda_stream",)
    return ("cuda_stream",) if big_db else CUDA_PATHS


def _probe_arrays(metric: str, nq: int, nk: int, d: int):
    """Deterministic numpy probe inputs, the reference's draws: Hamming words
    are its uint32 words viewed as int32, the port's layout."""
    rng = np.random.RandomState(0)
    if metric == "hamming":
        q = rng.randint(0, 2 ** 32, size=(nq, d),
                        dtype=np.uint64).astype(np.uint32).view(np.int32)
        db = rng.randint(0, 2 ** 32, size=(nk, d),
                         dtype=np.uint64).astype(np.uint32).view(np.int32)
    else:
        q = rng.randn(nq, d).astype(np.float32)
        db = rng.randn(nk, d).astype(np.float32)
    return q, db, np.ones((nk,), np.bool_)


def _sync(out) -> None:
    if out[0].is_cuda:
        torch.cuda.synchronize(out[0].device)


def _time_call(fn, *args) -> float:
    """Median-of-reps wall time in us, after a *blocking* warm-up (which on
    the card also absorbs the kernel's first build), each rep ending in a
    synchronization of the device."""
    _sync(fn(*args))
    samples = []
    for _ in range(_PROBE_REPS):
        t0 = time.perf_counter()
        _sync(fn(*args))
        samples.append(time.perf_counter() - t0)
    return float(np.median(samples) * 1e6)


def _default_device(backend: str) -> torch.device:
    if backend == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def measure_path(path: str, metric: str, nq: int, nk: int, d: int,
                 device=None) -> float:
    """One-shot microbenchmark of one candidate path at a (capped) bucket
    shape on ``device`` (default: the card where there is one, else the
    CPU); returns us per call.  The reference runs its probe in a thread of
    its own to escape a JAX trace; torch has no such trace, so this runs in
    the caller's thread."""
    global measure_count
    measure_count += 1
    obs_metrics.registry().counter("difet.kernel.dispatch_measures").inc()
    nq = min(nq, PROBE_NQ_CAP)
    nk = min(nk, PROBE_NK_CAP)
    if device is None:
        device = _default_device("cuda" if torch.cuda.is_available()
                                 else "cpu")
    from repro_torch.kernels import ops as _ops    # local: avoid cycle
    q, db, valid = _probe_arrays(metric, nq, nk, d)
    args = [torch.from_numpy(a).to(device)
            for a in (q, db, valid.astype(np.int32))]

    def fn(q, db, valid):
        return _ops.match_best2(q, db, valid, metric=metric, path=path)

    return _time_call(fn, *args)


def choose_path(metric: str, nq: int, nk: int, d: int, *,
                backend: Optional[str] = None,
                use_kernels: Optional[bool] = None, device=None) -> str:
    """The dispatch decision: fastest measured path for this bucket, where
    `DEFAULT_PATH` stays unless another is `SWITCH_MARGIN` times faster.

    First call per (metric, backend, bucket) runs the microbenchmark on
    ``device`` (default: ``backend``'s current device) and persists the
    verdict; later calls answer from the in-process memo or the disk cache.
    Single-candidate combinations skip measurement.  ``backend`` defaults
    to ``device``'s type, else ``cuda`` where the card is present.  A
    candidate that fails to build or launch raises; inside a CUDA graph
    capture a bucket with no verdict raises instead of measuring.
    """
    if backend is None:
        backend = device.type if device is not None else (
            "cuda" if torch.cuda.is_available() else "cpu")
    cands = candidate_paths(metric, backend, nk, d, use_kernels)
    if len(cands) == 1:
        return cands[0]
    key = bucket_key(metric, backend, nq, nk, d) \
        + "|" + "".join(sorted(_ABBREV[c] for c in cands))
    with _lock:
        hit = _memory.get(key)
    if hit is not None:
        return hit
    disk = _load_disk().get(key)
    if isinstance(disk, dict) and disk.get("path") in cands:
        with _lock:
            _memory[key] = disk["path"]
        return disk["path"]
    if backend == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"matcher dispatch: bucket {key} has no verdict and a CUDA graph "
            "capture cannot measure one; call match_best2 at this shape "
            "before the capture, or pin its path")
    device = _default_device(backend) if device is None else device
    qb, kb, db = shape_bucket(nq, nk, d)
    timings = {c: measure_path(c, metric, qb, kb, db, device)
               for c in cands}
    best = min(timings, key=timings.get)
    if (DEFAULT_PATH in timings
            and timings[DEFAULT_PATH] <= SWITCH_MARGIN * timings[best]):
        best = DEFAULT_PATH
    with _lock:
        _memory[key] = best
    for c, us in timings.items():              # probe wall → kernel profile
        obs_profile.record_call(f"dispatch:{metric}:{c}:q{qb}k{kb}d{db}",
                                us * 1e-6)
    # full provenance: enough to audit WHY this bucket routes where it
    # does without re-measuring (launch/obs.py --explain-dispatch)
    _store_disk(key, {"path": best, "us": timings,
                      "probe": [min(qb, PROBE_NQ_CAP),
                                min(kb, PROBE_NK_CAP), db],
                      "metric": metric, "backend": backend,
                      "bucket": [qb, kb, db],
                      "candidates": sorted(cands)})
    return best


def explain() -> Dict[str, dict]:
    """Decoded view of the on-disk dispatch cache: per bucket key, the
    winning path, its margin over the runner-up, and the full candidate
    timing table (``launch/obs.py --explain-dispatch`` renders this).  The
    margin is the fastest other candidate's time over the winner's: below 1
    where `DEFAULT_PATH` kept a bucket within `SWITCH_MARGIN`.  Entries
    written before provenance fields existed decode with
    ``metric``/``backend`` parsed from the key."""
    out: Dict[str, dict] = {}
    for key, entry in sorted(_load_disk().items()):
        if not isinstance(entry, dict) or "path" not in entry:
            continue
        parts = key.split("|")
        row = {"path": entry["path"],
               "metric": entry.get("metric", parts[0]),
               "backend": entry.get("backend",
                                    parts[1] if len(parts) > 1 else "?"),
               "bucket": entry.get("bucket"),
               "probe": entry.get("probe"),
               "candidates": entry.get("candidates",
                                       sorted(entry.get("us", {}))),
               "us": dict(entry.get("us", {}))}
        us = row["us"]
        if len(us) >= 2:
            ranked = sorted(us.items(), key=lambda kv: kv[1])
            if row["path"] in us:
                ranked = [(row["path"], us[row["path"]])] + [
                    kv for kv in ranked if kv[0] != row["path"]]
            row["margin"] = (ranked[1][1] / ranked[0][1]
                             if ranked[0][1] > 0 else float("inf"))
        out[key] = row
    return out
