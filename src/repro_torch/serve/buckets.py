"""Shape buckets + the per-(bucket, algorithm-set) program cache.

Port of ``repro/serve/buckets.py``.  A public tile service sees arbitrary
tile sizes, so incoming tiles are padded into a small static table of
interior sizes (the *buckets*); batches are always padded to the
scheduler's fixed ``max_batch``; and the algorithm set is canonicalized —
so the number of programs is exactly ``len(buckets) × len(distinct
algorithm sets)``, each built once (``CompileCache``), and ``warmup``
pre-pays all of them before traffic arrives.

The reference jit-compiles one program per pair.  Here the program is a
CUDA graph: the engine's step (`core/engine.py::make_serve_step`, about a
thousand kernel launches at seven algorithms) is captured once at the
fixed batch shape (`ServeGraph`) and replayed for every batch, so a step
costs one graph launch on the host instead of one dispatch per op.  On the
card a capture that fails raises: the step never runs eagerly instead.
With ``device="cpu"`` the step runs eagerly (`EagerStep`).

Each service's programs capture, upload, replay and copy back on a CUDA
stream of the service's own, so replicas in one process (a thread fleet)
never meet on the legacy default stream, and one process captures one
graph at a time (`_CAPTURE_LOCK`): ``torch.cuda.graph`` synchronizes the
device before it begins, which must not happen while another thread's
capture is in flight.  A service that captures under traffic (a replica
spawned by the autoscaler) thus never disturbs the others' replays.

Padding reuses the engine's own convention: a request tile is treated as
a one-tile scene (`core/bundle.py::tile_scene`), giving a reflect-padded
halo ring and a header whose ``valid_h/valid_w`` confine detection to the
request's real pixels — bucket padding can never emit keypoints
(`nms.interior_mask`), so results are independent of which bucket a tile
landed in beyond the documented tile-size semantics.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.difet_paper import DifetConfig
from repro_torch.core.bundle import tile_scene
from repro_torch.core.engine import make_serve_step, resolve_device
from repro_torch.data.pipeline import pinned_empty
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import profile as obs_profile
from repro_torch.obs import trace as obs_trace

# one graph capture at a time in this process (module docstring)
_CAPTURE_LOCK = threading.Lock()


class BucketTable:
    """Static table of interior sizes; ``bucket_for`` picks the smallest
    bucket that holds a tile (None = bigger than every bucket, the caller
    splits it into a multi-tile scene request)."""

    def __init__(self, interiors: Sequence[int], base: DifetConfig):
        self.interiors: Tuple[int, ...] = tuple(sorted(set(int(i)
                                                           for i in interiors)))
        if not self.interiors:
            raise ValueError("bucket table needs at least one interior size")
        self.base = base
        self._cfgs: Dict[int, DifetConfig] = {}

    @property
    def halo(self) -> int:
        return self.base.halo

    def bucket_for(self, h: int, w: int) -> Optional[int]:
        side = max(int(h), int(w))
        for interior in self.interiors:
            if side <= interior:
                return interior
        return None

    def cfg_for(self, bucket: int) -> DifetConfig:
        if bucket not in self._cfgs:
            if bucket not in self.interiors:
                raise KeyError(f"{bucket} is not a bucket "
                               f"(table: {self.interiors})")
            self._cfgs[bucket] = dataclasses.replace(self.base, tile=bucket)
        return self._cfgs[bucket]

    def pad_to_bucket(self, gray: np.ndarray, bucket: int):
        """Pad one grayscale tile into its bucket canvas.  Returns
        ``(tile [hw, hw] float32, header [6] int32)`` with hw =
        bucket + 2*halo; the header's valid extent is the tile's own
        shape, so detection ignores the padding.  Output is bit-identical
        to ``tile_scene`` on the same tile (tested) — the fast path just
        skips ``np.pad``'s generic machinery, which dominated the
        per-request submit cost."""
        gray = np.asarray(gray, np.float32)
        h, w = gray.shape
        if min(h, w) < 2:
            raise ValueError(f"tile {h}x{w} too small: reflect padding "
                             f"needs at least 2 pixels per side")
        tile = _reflect_pad_fast(gray, bucket, self.halo)
        if tile is None:    # pad needs numpy's multi-bounce reflection
            b = tile_scene(gray, self.cfg_for(bucket))
            if len(b) != 1:
                raise ValueError(f"tile {h}x{w} exceeds bucket {bucket}")
            return b.tiles[0], b.headers[0]
        header = np.array([0, 0, 0, h, w, 0], np.int32)
        return tile, header


def _reflect_pad_fast(gray: np.ndarray, t: int, halo: int):
    """Single-bounce reflect pad of one tile to ``(t+2h) x (t+2h)`` —
    exactly ``np.pad(gray, ((h, h+t-H), (h, h+t-W)), 'reflect')`` (the
    ``tile_scene`` convention: axis 0 first, then axis 1 over the padded
    rows), hand-rolled as six slice copies.  Returns None when any pad
    width needs numpy's multi-bounce reflection (tiny tiles in big
    buckets) and the caller falls back to ``tile_scene``."""
    h, w = gray.shape
    pb, pr = halo + t - h, halo + t - w          # bottom / right pad widths
    if max(halo, pb) > h - 1 or max(halo, pr) > w - 1:
        return None
    hw = t + 2 * halo
    rows = np.empty((hw, w), np.float32)
    rows[halo:halo + h] = gray
    rows[:halo] = gray[halo:0:-1]
    rows[halo + h:] = gray[h - 2::-1][:pb]
    out = np.empty((hw, hw), np.float32)
    out[:, halo:halo + w] = rows
    out[:, :halo] = rows[:, halo:0:-1]
    out[:, halo + w:] = rows[:, w - 2::-1][:, :pr]
    return out


def pack_outputs(outputs):
    """``{alg: {key: tensor}}`` as one flat uint8 tensor and its layout
    ``[(alg, key, byte offset, bytes, numpy dtype, shape)]``.  Outputs go
    widest dtype first, so each one starts aligned for its dtype."""
    leaves = sorted(((alg, k, v) for alg, res in outputs.items()
                     for k, v in res.items()),
                    key=lambda leaf: -leaf[2].element_size())
    packed = torch.cat([v.reshape(-1).view(torch.uint8)
                        for _, _, v in leaves])
    layout, offset = [], 0
    for alg, k, v in leaves:
        n = v.numel() * v.element_size()
        dtype = torch.empty((), dtype=v.dtype).numpy().dtype
        layout.append((alg, k, offset, n, dtype, tuple(v.shape)))
        offset += n
    return packed, layout


def unpack_outputs(raw: np.ndarray, layout):
    """Inverse of `pack_outputs` on the host: numpy views into ``raw``."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for alg, k, offset, n, dtype, shape in layout:
        out.setdefault(alg, {})[k] = \
            raw[offset:offset + n].view(dtype).reshape(shape)
    return out


class EagerStep:
    """The serving step run op by op (``device="cpu"``): numpy batch in,
    ``{alg: {key: numpy}}`` out."""

    def __init__(self, step):
        self.step = step

    def __call__(self, tiles: np.ndarray, headers: np.ndarray):
        out = self.step(torch.from_numpy(tiles), torch.from_numpy(headers))
        return {alg: {k: v.numpy() for k, v in res.items()}
                for alg, res in out.items()}


class ServeGraph:
    """One (bucket, algorithm-set) step captured as a CUDA graph.

    The step runs on static device buffers (``tiles`` [B, hw, hw] f32,
    ``headers`` [B, 6] i32): once eagerly on ``stream`` (which builds and
    loads the kernel libraries and sets their one-time attributes outside
    the capture), then under ``torch.cuda.graph`` into ``pool``, captured
    on ``stream`` too; every call uploads, replays and copies back on it.
    The capture also packs every output into one byte buffer
    (`pack_outputs`), which a call copies to pinned host memory and
    unpacks: one copy back and one wait a step.

    A call overwrites the static inputs and outputs: graphs that share a
    pool must be called one at a time, each call's result read before the
    next call (the service's runner thread does exactly that)."""

    def __init__(self, step, batch: int, hw: int, device: torch.device,
                 pool, stream: torch.cuda.Stream):
        self.device = device
        self.stream = stream
        with torch.cuda.device(device), torch.cuda.stream(stream):
            self.tiles = torch.zeros((batch, hw, hw), dtype=torch.float32,
                                     device=device)
            self.headers = torch.zeros((batch, 6), dtype=torch.int32,
                                       device=device)
            self.headers[:, 5] = 1
            step(self.tiles, self.headers)
            stream.synchronize()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                self.outputs = step(self.tiles, self.headers)
                self.packed, self.layout = pack_outputs(self.outputs)
            self.host = torch.empty(self.packed.numel(), dtype=torch.uint8,
                                    pin_memory=True)
            self.done = torch.cuda.Event()

    def replay(self, tiles: np.ndarray, headers: np.ndarray) -> None:
        """Stage a batch into the static inputs (``non_blocking``; pinned
        sources copy asynchronously) and launch the graph."""
        with torch.cuda.stream(self.stream):
            self.tiles.copy_(torch.from_numpy(tiles), non_blocking=True)
            self.headers.copy_(torch.from_numpy(headers), non_blocking=True)
            self.graph.replay()

    def fetch(self):
        """The last replay's outputs as ``{alg: {key: numpy}}``: one copy
        of the packed buffer to pinned memory, one wait on its event, and
        one host copy (the staging buffer is reused by the next step)."""
        with torch.cuda.stream(self.stream):
            self.host.copy_(self.packed, non_blocking=True)
            self.done.record(self.stream)
        self.done.synchronize()
        return unpack_outputs(self.host.numpy().copy(), self.layout)

    def __call__(self, tiles: np.ndarray, headers: np.ndarray):
        self.replay(tiles, headers)
        return self.fetch()


class CompileCache:
    """(bucket, algorithm-set) → serving program; one program each.

    The scheduler pads every batch to ``max_batch`` rows, so each program
    sees exactly one input shape.  On a CUDA device a program is a
    `ServeGraph`, all of one cache's graphs in one memory pool and on one
    stream of the cache's own (one runner thread calls them one at a
    time); on the CPU it is an `EagerStep`.
    ``programs`` counts distinct programs built — the serving metric the
    benchmark reports as compile-cache size."""

    def __init__(self, table: BucketTable, max_batch: int,
                 use_kernels: bool = True, device=None):
        self.table = table
        self.max_batch = int(max_batch)
        self.use_kernels = use_kernels
        self.device = resolve_device(device)
        cuda = self.device.type == "cuda"
        self._pool = torch.cuda.graph_pool_handle() if cuda else None
        self.stream = torch.cuda.Stream(self.device) if cuda else None
        self._fns: Dict[tuple, object] = {}

    @property
    def programs(self) -> int:
        return len(self._fns)

    def keys(self):
        return sorted(self._fns)

    def get(self, bucket: int, algorithms: Tuple[str, ...]):
        key = (int(bucket), tuple(algorithms))
        fn = self._fns.get(key)
        if fn is not None:
            return fn
        with _CAPTURE_LOCK:
            fn = self._fns.get(key)
            if fn is None:
                step = make_serve_step(key[1], self.table.cfg_for(key[0]),
                                       self.use_kernels, self.device)
                if self.device.type == "cuda":
                    fn = ServeGraph(step, self.max_batch,
                                    key[0] + 2 * self.table.halo,
                                    self.device, self._pool, self.stream)
                else:
                    fn = EagerStep(step)
                self._fns[key] = fn
        return fn

    def empty_batch(self, bucket: int):
        """An all-padding batch at this bucket's device shape (header pad
        flag set, so nothing detects) — the warm-up input, also used by the
        scheduler runner as the canvas real tiles are scattered into.  On
        the card it lives in pinned memory, so a step's upload is
        asynchronous."""
        hw = bucket + 2 * self.table.halo
        alloc = pinned_empty if self.device.type == "cuda" else np.empty
        tiles = alloc((self.max_batch, hw, hw), np.float32)
        headers = alloc((self.max_batch, 6), np.int32)
        tiles[:] = 0
        headers[:] = 0
        headers[:, 5] = 1
        return tiles, headers


def warmup(compile_cache: CompileCache,
           algorithm_sets: Sequence[Tuple[str, ...]],
           buckets: Optional[Sequence[int]] = None) -> int:
    """Warm-up driver: build every (bucket, algorithm-set) program (on the
    card: the eager warm-up and the graph capture) and push one
    all-padding batch through it, so no live request ever pays a build.
    The build and first call are timed into ``difet.compile.program_s``
    and the kernel profiler.  Returns the number of programs."""
    hist = obs_metrics.registry().histogram("difet.compile.program_s")
    for bucket in (buckets if buckets is not None
                   else compile_cache.table.interiors):
        tiles, headers = compile_cache.empty_batch(bucket)
        for algs in algorithm_sets:
            key = (int(bucket), tuple(algs))
            fresh = key not in compile_cache._fns
            t0 = time.monotonic()
            compile_cache.get(bucket, tuple(algs))(tiles, headers)
            t1 = time.monotonic()
            if fresh:                          # first call = build + run
                hist.observe(t1 - t0)
                obs_profile.record_compile(
                    f"serve:{bucket}:{'+'.join(algs)}", t1 - t0)
                if obs_trace.enabled():
                    obs_trace.emit_span(
                        "compile_program", "compile", t0, t1, trace_id="",
                        bucket=bucket, algorithms=",".join(algs))
    return compile_cache.programs
