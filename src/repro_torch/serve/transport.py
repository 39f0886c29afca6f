"""Spooled-file request/response transport between the fleet router
process and its replica worker processes.

Port of ``repro/serve/transport.py`` with the same wire format: a message
written by either package decodes in the other.

The cross-process fleet (`serve/proc.py`) needs a request channel with
the same failure discipline as the rest of the stack: a reader must see
either a *complete* message or no message, a writer crash (``kill -9``
mid-write) must leave nothing a peer could mistake for a message, and a
message that survived the writer's death must remain deliverable.  The
spooled-file transport gets all three from the filesystem primitives the
repo already trusts (`core/job.py::LeaseBoard`,
`serve/cache.py::DiskCacheTier`): every message is one ``.npz`` file
written tmp-then-atomic-rename, so the visible file *is* the commit.

Layout (one :class:`WorkerMailbox` directory per replica)::

    <root>/<replica-name>/
        req/    <rid>.npz      router → worker   (atomic rename)
        work/   <rid>.npz      claimed requests  (worker renames in)
        resp/   <rid>.npz      worker → router   (atomic rename)
        ctrl/   drain          control flags (empty marker files)
        telemetry/ <w>-<seq>.npz  worker → router telemetry shipments
                               (obs/ship.py; parent consumes)
        chaos.json             fault-injection plan (serve/chaos.py)
        ready.npz              worker warm-up complete marker
        stats.npz              worker's latest stats() snapshot
        worker.log             worker stdout/stderr

Requests persist until the worker *claims* them (rename into ``work/``)
and responses persist until the router collects them — so a SIGKILL'd
worker leaves its unserved requests enumerable (the router re-admits
them to survivors) and its already-written responses deliverable (work
that finished before the crash is never recomputed).  A torn or corrupt
message (a fault-injection write, a partial tmp left by a dead writer)
is quarantined and skipped, never delivered.

Payloads are numpy trees + one JSON metadata dict, packed into a single
``.npz``: arrays keep dtype/shape bit-exactly (0-d leaves tagged
``__0d`` exactly like the disk cache tier), metadata rides as a
UTF-8-encoded ``uint8`` array under ``__meta__``.
"""
from __future__ import annotations

import io
import json
import os
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["encode_message", "decode_message", "write_message",
           "read_message", "read_snapshot", "WorkerMailbox"]

_META = "__meta__"


def encode_message(meta: Dict[str, object],
                   arrays: Optional[Dict[str, np.ndarray]] = None) -> bytes:
    """Pack one message (JSON-able ``meta`` + named numpy ``arrays``)
    into ``.npz`` bytes.  0-d arrays are tagged so decode restores exact
    shape; array names must not collide with the ``__meta__`` slot."""
    payload = {}
    for k, v in (arrays or {}).items():
        if k == _META:
            raise ValueError(f"array name {_META!r} is reserved")
        a = np.asarray(v)
        payload[k + "__0d" if a.ndim == 0 else k] = a
    payload[_META] = np.frombuffer(
        json.dumps(meta, sort_keys=True).encode(), np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **payload)
    return buf.getvalue()


def decode_message(raw: bytes) -> Tuple[Dict[str, object],
                                        Dict[str, np.ndarray]]:
    """Inverse of `encode_message`: ``(meta, arrays)`` with every array
    frozen read-only.  Raises on a torn/corrupt payload (``ValueError``,
    ``KeyError``, ``zipfile.BadZipFile``) — callers quarantine."""
    with np.load(io.BytesIO(raw), allow_pickle=False) as z:
        meta = json.loads(bytes(z[_META]).decode())
        arrays = {}
        for k in z.files:
            if k == _META:
                continue
            a = z[k]
            if k.endswith("__0d"):
                k, a = k[:-4], a.reshape(())
            a.setflags(write=False)
            arrays[k] = a
    return meta, arrays


def write_message(path: Path, meta: Dict[str, object],
                  arrays: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Atomically publish one message at ``path`` (tmp + rename, unique
    per-writer tmp name — the `DiskCacheTier` discipline, so a crash
    mid-write never exposes a torn message)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp.{os.getpid()}.{threading.get_ident()}")
    tmp.write_bytes(encode_message(meta, arrays))
    tmp.replace(path)


def read_message(path: Path) -> Optional[Tuple[Dict[str, object],
                                               Dict[str, np.ndarray]]]:
    """Read + decode one message; None when absent.  A corrupt file is
    quarantined (renamed ``*.corrupt``) and reads as absent — the
    torn-write chaos test drives this path."""
    try:
        raw = path.read_bytes()
    except OSError:
        return None
    try:
        return decode_message(raw)
    except Exception:  # noqa: BLE001 — any torn/corrupt payload; np.load
        # raises EOFError on an empty file and struct.error on a partial
        # zip header, beyond the documented ValueError/BadZipFile set
        try:
            path.rename(path.with_suffix(path.suffix + ".corrupt"))
        except OSError:
            pass
        return None


def read_snapshot(path: Path) -> Optional[Tuple[Dict[str, object],
                                                Dict[str, np.ndarray]]]:
    """Read a *republished* snapshot channel (``stats.npz``,
    ``ready.npz``): like `read_message`, but a torn/partial/corrupt file
    reads as "not yet" **without** quarantining — the writer overwrites
    the same path every interval, so renaming a torn read aside would
    discard the next perfectly good publish's landing spot and turn one
    torn write into a permanently missing channel.  Regression-tested
    against truncated stats files in ``tests/test_torch_telemetry.py``."""
    try:
        raw = path.read_bytes()
    except OSError:
        return None
    try:
        return decode_message(raw)
    except Exception:  # noqa: BLE001 — torn mid-write/mid-rename read
        return None


class WorkerMailbox:
    """One replica's transport directory (see module docstring).

    Both sides construct it over the same path: the router uses
    `send_request` / `try_read_response` / `pending_requests`, the
    worker uses `claim_requests` / `send_response` plus the control
    helpers.  All operations are safe against the peer dying at any
    instruction boundary."""

    def __init__(self, root):
        self.root = Path(root)
        self.req = self.root / "req"
        self.work = self.root / "work"
        self.resp = self.root / "resp"
        self.ctrl = self.root / "ctrl"
        self.tele = self.root / "telemetry"
        for d in (self.req, self.work, self.resp, self.ctrl, self.tele):
            d.mkdir(parents=True, exist_ok=True)

    # ---- router side --------------------------------------------------------
    def send_request(self, rid: str, meta: Dict[str, object],
                     arrays: Dict[str, np.ndarray]) -> None:
        """Publish request ``rid`` into the worker's inbox."""
        write_message(self.req / f"{rid}.npz", meta, arrays)

    def try_read_response(self, rid: str) -> Optional[Tuple[Dict, Dict]]:
        """The worker's response to ``rid``, or None if not (yet)
        written.  Responses persist — a response written before the
        worker died is still deliverable."""
        return read_message(self.resp / f"{rid}.npz")

    def has_response(self, rid: str) -> bool:
        """Cheap readiness probe (one stat)."""
        return (self.resp / f"{rid}.npz").exists()

    def pending_requests(self) -> List[str]:
        """rids the worker has neither claimed nor answered — what a dead
        worker leaves behind for re-admission accounting."""
        claimed = {p.stem for p in self.work.glob("*.npz")}
        answered = {p.stem for p in self.resp.glob("*.npz")}
        out = []
        for p in self.req.glob("*.npz"):
            if p.stem not in answered:
                out.append(p.stem)
        out.extend(r for r in claimed if r not in answered)
        return sorted(set(out))

    def request_drain(self) -> None:
        """Raise the drain flag: the worker finishes every claimed +
        inbox request, answers them all, then exits cleanly."""
        (self.ctrl / "drain").touch()

    # ---- worker side --------------------------------------------------------
    def claim_requests(self) -> List[Tuple[str, Dict, Dict]]:
        """Claim every inbox request (atomic rename into ``work/`` —
        claim-then-read, so a crash after claim still shows the request
        as claimed-but-unanswered to `pending_requests`).  Corrupt
        requests are quarantined and skipped.  Returns
        ``[(rid, meta, arrays), ...]`` in rid order."""
        out = []
        for path in sorted(self.req.glob("*.npz")):
            claimed = self.work / path.name
            try:
                path.rename(claimed)
            except OSError:
                continue                       # raced / vanished: skip
            msg = read_message(claimed)
            if msg is None:
                continue                       # quarantined by read_message
            out.append((path.stem, msg[0], msg[1]))
        return out

    def send_response(self, rid: str, meta: Dict[str, object],
                      arrays: Dict[str, np.ndarray]) -> None:
        """Publish the response for ``rid`` and retire its claimed
        request file (response first — the commit point — so a crash
        between the two at worst leaves a claimed request *with* a
        response, which `pending_requests` already treats as done)."""
        write_message(self.resp / f"{rid}.npz", meta, arrays)
        try:
            (self.work / f"{rid}.npz").unlink()
        except OSError:
            pass

    def drain_requested(self) -> bool:
        """Has the router asked this worker to drain?"""
        return (self.ctrl / "drain").exists()

    # ---- telemetry channel (obs/ship.py → obs/agg.py) -----------
    def publish_telemetry(self, worker: str, seq: int,
                          meta: Dict[str, object]) -> None:
        """Worker: spool one sequenced telemetry shipment (atomic
        rename, like every other message; the parent consumes it)."""
        write_message(self.tele / f"{worker}-{seq:08d}.npz", meta)

    def collect_telemetry(self) -> List[Dict[str, object]]:
        """Router: drain every spooled telemetry shipment, in sequence
        order, deleting each file once read — the channel is a queue,
        not a snapshot.  Torn/corrupt shipments are quarantined by
        `read_message` and skipped (one lost interval of deltas, never a
        double-count)."""
        out = []
        for path in sorted(self.tele.glob("*.npz")):
            msg = read_message(path)
            if msg is not None:
                out.append(msg[0])
            try:
                path.unlink()
            except OSError:
                pass                      # quarantined or raced: gone either way
        return out

    # ---- shared markers -----------------------------------------------------
    def write_ready(self, info: Dict[str, object]) -> None:
        """Worker: publish the warm-up-complete marker (atomic)."""
        write_message(self.root / "ready.npz", info)

    def read_ready(self) -> Optional[Dict[str, object]]:
        """Router: the worker's ready marker — None while warming *or*
        on a torn/partial read (`read_snapshot`: a snapshot channel
        reads as "not yet", it is never quarantined)."""
        msg = read_snapshot(self.root / "ready.npz")
        return msg[0] if msg else None

    def write_stats(self, stats: Dict[str, object]) -> None:
        """Worker: publish the latest ``stats()`` snapshot."""
        write_message(self.root / "stats.npz", stats)

    def read_stats(self) -> Optional[Dict[str, object]]:
        """Router: the worker's last stats snapshot — None before the
        first publish or on a torn/partial read (`read_snapshot`; the
        next periodic publish repairs the channel)."""
        msg = read_snapshot(self.root / "stats.npz")
        return msg[0] if msg else None
