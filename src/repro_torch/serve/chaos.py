"""Fault-injection primitives for the cross-process fleet.

Port of ``repro/serve/chaos.py``.  The chaos surface — kill -9 a
replica process, partition the cache directory, tear an ``.npz``
mid-write, stall a heartbeat — lives here as a small library that both
the tests (`tests/test_torch_proc_fleet.py`) and the launch driver
(`launch/fleet.py --kill-after`) drive, so a fault exercised in CI is
the *same code path* a human reproduces from the command line.

Two delivery channels:

* **In-band plans** (:class:`ChaosPlan`): a JSON file dropped into a
  worker's mailbox directory.  The `serve/proc.py` worker re-reads it
  every loop iteration, so a test can make a *live* worker stop
  heartbeating (stale-lease detection with the process still running),
  sit on finished responses (keeping work outstanding across a kill),
  or ``os._exit(137)`` itself after serving N requests (a self-inflicted
  ``kill -9`` at a deterministic point in the request stream).
* **Out-of-band faults**: :func:`sigkill` (real ``SIGKILL``, no atexit,
  no cleanup), :func:`cache_partition` (make the shared cache dir
  unreachable for a block), :func:`tear_file` (truncate a committed
  file to simulate a torn write that somehow became visible).

Everything here is deterministic — no random fault schedules; tests
choose the exact span at which a fault lands.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Optional

__all__ = ["ChaosPlan", "write_plan", "read_plan", "clear_plan",
           "sigkill", "cache_partition", "tear_file"]

PLAN_FILE = "chaos.json"


@dataclasses.dataclass
class ChaosPlan:
    """One worker's fault-injection plan (all faults off by default).

    ``heartbeat_stall_s``: skip lease heartbeats for this many seconds
    after the plan lands (the worker otherwise runs normally — this is
    how tests exercise stale-lease detection on a *live* process).
    ``hold_responses_s``: finish work but withhold the response files
    for this many seconds (keeps requests outstanding at a chosen span,
    e.g. across a concurrent ``kill -9``).
    ``exit_after_requests``: ``os._exit(137)`` immediately after the
    N-th response is written — a deterministic self-``kill -9`` leaving
    claimed-but-unanswered requests behind.
    ``plan_time`` is stamped by `read_plan` from the file's mtime; the
    stall windows are measured from it.
    """
    heartbeat_stall_s: float = 0.0
    hold_responses_s: float = 0.0
    exit_after_requests: int = 0
    plan_time: float = 0.0

    def heartbeat_stalled(self, now: Optional[float] = None) -> bool:
        """Is the heartbeat stall window active at ``now``?"""
        if self.heartbeat_stall_s <= 0:
            return False
        now = time.time() if now is None else now
        return now - self.plan_time < self.heartbeat_stall_s

    def responses_held(self, now: Optional[float] = None) -> bool:
        """Is the response-withholding window active at ``now``?"""
        if self.hold_responses_s <= 0:
            return False
        now = time.time() if now is None else now
        return now - self.plan_time < self.hold_responses_s


def write_plan(mailbox_root, plan: ChaosPlan) -> None:
    """Drop ``plan`` into a worker's mailbox (atomic rename, so the
    worker never reads a torn plan)."""
    root = Path(mailbox_root)
    root.mkdir(parents=True, exist_ok=True)
    fields = {k: v for k, v in dataclasses.asdict(plan).items()
              if k != "plan_time"}
    tmp = root / f".{PLAN_FILE}.tmp.{os.getpid()}"
    tmp.write_text(json.dumps(fields))
    tmp.replace(root / PLAN_FILE)


def read_plan(mailbox_root) -> ChaosPlan:
    """The active plan for a mailbox (an all-off plan when absent or
    unreadable — chaos must never take a worker down by accident)."""
    path = Path(mailbox_root) / PLAN_FILE
    try:
        raw = json.loads(path.read_text())
        mtime = path.stat().st_mtime
    except (OSError, ValueError):
        return ChaosPlan()
    known = {f.name for f in dataclasses.fields(ChaosPlan)}
    fields = {k: v for k, v in raw.items() if k in known and k != "plan_time"}
    return ChaosPlan(plan_time=mtime, **fields)


def clear_plan(mailbox_root) -> None:
    """Remove any active plan (faults off)."""
    try:
        (Path(mailbox_root) / PLAN_FILE).unlink()
    except OSError:
        pass


def sigkill(pid: int) -> None:
    """``kill -9`` — no Python-level cleanup, no atexit, no flush.  The
    process gets no chance to release leases or finish writes; already
    dead is fine."""
    try:
        os.kill(pid, signal.SIGKILL)
    except ProcessLookupError:
        pass


@contextmanager
def cache_partition(path):
    """Make a directory unreachable for the block's duration — the
    "partitioned cache directory" fault.  Replicas must degrade to
    recomputing (disk tier counts errors/misses) rather than crash.

    Implementation note: the directory is moved aside and replaced by a
    plain *file*, so every mkdir/write/read beneath it fails with an
    ``OSError`` — unlike a chmod-000 fault, this holds even when tests
    run as root (root bypasses permission bits entirely)."""
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    moved = p.with_name(p.name + ".partitioned")
    p.rename(moved)
    p.touch()
    try:
        yield p
    finally:
        p.unlink()
        moved.rename(p)


def tear_file(path, keep: int = 64) -> Path:
    """Truncate a committed file to its first ``keep`` bytes in place —
    the "torn write became visible" fault (e.g. a non-atomic writer or
    a filesystem that lied about rename durability).  Readers must treat
    the result as absent/corrupt, never as data."""
    p = Path(path)
    data = p.read_bytes()[:keep]
    p.write_bytes(data)
    return p
