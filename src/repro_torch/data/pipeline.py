"""Streaming tile pipeline: scene stripes -> halo tiles -> staged batches.

Port of ``repro/data/pipeline.py``.  The eager path
(`core/bundle.py::tile_scene`) pads a whole scene in host memory and cuts
every tile at once; this module streams instead, so host memory stays
bounded whatever the scene's height:

    SceneReader.stripes()  ->  StreamTiler  ->  batch packer  ->  Prefetcher
    (row stripes, mmap)        (halo tiles,     (fixed-shape      (host thread,
                                row window)      TileBundles)      copy stream)

* `StreamTiler` keeps only the row window a tile row needs (reflect padding
  included).  Its tiles and headers are bit-identical to `tile_scene`'s, in
  the same order.
* `iter_tile_batches` packs the tiles of a scene sequence into fixed-shape
  `TileBundle` batches (the last one pad-flagged to shape); the batch index
  is the manifest work item a worker owns.  ``alloc`` lets the packer write
  each batch straight into the memory it is staged from (`pinned_empty`).
* `Prefetcher` runs the iterator on a host thread behind a bounded queue
  (depth 2 = double buffering) and, with ``device_put=True``, stages each
  batch onto the device: on the card, from pinned host memory with
  ``non_blocking`` copies on its own CUDA stream, the consumer's stream
  waiting on the copy's event.  Errors propagate to the consumer;
  ``close()`` always reclaims the thread.

The numpy parts are copies of the reference's and bitwise equal to it.  The
reference's ``sharding`` argument to the prefetcher is ``mesh=`` here: each
batch is cut into its mesh entries' row slices (`distributed/sharding.py`),
each copied from the batch's pinned buffer straight to its own card on a
copy stream of that card.
"""
from __future__ import annotations

import queue
import threading
from typing import (Callable, Iterable, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.configs.difet_paper import DifetConfig
from repro_torch.core.bundle import TileBundle
from repro_torch.core.engine import resolve_device
from repro_torch.data.landsat import SceneReader
from repro_torch.distributed.sharding import Mesh, Sharded, split_rows

__all__ = ["StreamTiler", "iter_scene_tiles", "iter_tile_batches",
           "Prefetcher", "reflect_indices", "pinned_empty"]


def reflect_indices(n: int, pad_before: int, pad_after: int) -> np.ndarray:
    """Source indices for ``np.pad(mode="reflect")`` along one axis.

    Returns int64 ``[pad_before + n + pad_after]`` mapping each padded
    position to its source index in ``[0, n)``: numpy's even reflection
    (no edge repeat), multi-bounce for pads wider than the axis.  Lets the
    tiler compute any padded row from raw scene rows.
    """
    if n == 1:
        return np.zeros(pad_before + 1 + pad_after, np.int64)
    j = np.arange(-pad_before, n + pad_after)
    period = 2 * (n - 1)
    j = np.abs(j) % period
    return np.where(j >= n, period - j, j)


class StreamTiler:
    """Incremental `tile_scene`: feed row stripes, collect finished tiles.

    Tiles come out in `tile_scene`'s row-major ``(ty, tx)`` order with its
    float32 values and int32 headers, bit for bit.  Each arriving stripe is
    reflect-padded horizontally once; a tile row is emitted as soon as the
    last raw row it references (bottom reflection included) has arrived,
    and raw rows no later tile row references are dropped.

    Args:
        h, w:      scene extent in pixels (known up front from the reader).
        cfg:       tiling geometry (``cfg.tile`` interior, ``cfg.halo``
                   overlap ring).
        scene_id:  stamped into every emitted header.

    Call ``feed(stripe)`` per stripe and ``finish()`` once after the last;
    both return ``(tiles, headers)`` lists for the tile rows that completed.
    """

    def __init__(self, h: int, w: int, cfg: DifetConfig, scene_id: int = 0):
        if h <= 0 or w <= 0:
            raise ValueError(f"empty scene: {h}x{w}")
        t, halo = cfg.tile, cfg.halo
        self.cfg = cfg
        self.scene_id = scene_id
        self.h, self.w = h, w
        self.ny = (h + t - 1) // t
        self.nx = (w + t - 1) // t
        # padded row (height ny*t + 2*halo) -> source scene row, exactly
        # np.pad(reflect)
        self._row_src = reflect_indices(h, halo, halo + self.ny * t - h)
        self._col_pad = (halo, halo + self.nx * t - w)
        # per tile row: the last raw row it references decides readiness
        self._last_needed = [
            int(self._row_src[ty * t: ty * t + t + 2 * halo].max())
            for ty in range(self.ny)]
        # raw row -> number of tile rows still referencing it (eviction)
        self._refcount = np.zeros(h, np.int64)
        for ty in range(self.ny):
            for r in np.unique(self._row_src[ty * t:
                                             ty * t + t + 2 * halo]):
                self._refcount[r] += 1
        self._rows = {}          # raw row index -> horizontally padded row
        self._next_row = 0       # next raw row index expected from feed()
        self._next_ty = 0        # next tile row to emit

    def feed(self, stripe: np.ndarray) -> Tuple[List[np.ndarray],
                                                List[Tuple]]:
        """Consume one ``[rows, w]`` stripe; return the tiles it completed.

        Stripes must arrive in order and cover the scene exactly; a stripe
        of another width, or one past the scene's end, raises.
        """
        stripe = np.asarray(stripe, np.float32)
        if stripe.ndim != 2 or stripe.shape[1] != self.w:
            raise ValueError(f"stripe shape {stripe.shape} does not match "
                             f"scene width {self.w}")
        if self._next_row + stripe.shape[0] > self.h:
            raise ValueError(
                f"stripe overruns scene: rows "
                f"[{self._next_row}, {self._next_row + stripe.shape[0]}) "
                f"beyond h={self.h}")
        keep = [i for i in range(stripe.shape[0])
                if self._refcount[self._next_row + i]]
        if keep:
            # one pad for the whole stripe: the reference's per-row pads,
            # bit for bit, without a Python call per row (the producer
            # thread holds the interpreter lock less)
            padded = np.pad(stripe, ((0, 0), self._col_pad), mode="reflect")
            for i in keep:
                self._rows[self._next_row + i] = padded[i]
        self._next_row += stripe.shape[0]
        return self._drain()

    def finish(self) -> Tuple[List[np.ndarray], List[Tuple]]:
        """Check full coverage and return any remaining tile rows."""
        if self._next_row != self.h:
            raise ValueError(f"scene truncated: got {self._next_row} of "
                             f"{self.h} rows")
        tiles, headers = self._drain()
        if self._next_ty != self.ny:
            raise AssertionError("tiler finished with pending tile rows")
        return tiles, headers

    def _drain(self):
        t, halo = self.cfg.tile, self.cfg.halo
        tiles, headers = [], []
        while (self._next_ty < self.ny
               and self._last_needed[self._next_ty] < self._next_row):
            ty = self._next_ty
            src = self._row_src[ty * t: ty * t + t + 2 * halo]
            slab = np.stack([self._rows[int(r)] for r in src])
            for tx in range(self.nx):
                x0 = tx * t
                tiles.append(slab[:, x0:x0 + t + 2 * halo])
                headers.append((self.scene_id, ty, tx,
                                min(t, self.h - ty * t),
                                min(t, self.w - tx * t), 0))
            for r in np.unique(src):
                self._refcount[r] -= 1
                if self._refcount[r] == 0:
                    del self._rows[int(r)]
            self._next_ty += 1
        return tiles, headers


def iter_scene_tiles(reader: SceneReader, cfg: DifetConfig,
                     scene_id: int = 0,
                     stripe_rows: Optional[int] = None):
    """Stream one scene's halo tiles: yields ``(tile, header)`` pairs in
    `tile_scene` order without materializing the scene.  ``stripe_rows``
    defaults to one tile row's worth of raw rows."""
    h, w = reader.shape
    stripe_rows = stripe_rows or (cfg.tile + 2 * cfg.halo)
    tiler = StreamTiler(h, w, cfg, scene_id)
    for stripe in reader.stripes(stripe_rows):
        for pair in zip(*tiler.feed(stripe)):
            yield pair
    for pair in zip(*tiler.finish()):
        yield pair


def scene_tile_count(shape: Tuple[int, int], cfg: DifetConfig) -> int:
    """Tiles `tile_scene` cuts from a scene of this shape (header arithmetic,
    no pixel read)."""
    h, w = shape
    return (((h + cfg.tile - 1) // cfg.tile)
            * ((w + cfg.tile - 1) // cfg.tile))


def count_batches(shapes: Sequence[Tuple[int, int]], cfg: DifetConfig,
                  batch_tiles: int) -> int:
    """Batches `iter_tile_batches` yields for scenes of these shapes, so a
    manifest can be written before any pixel is read."""
    total = sum(scene_tile_count(s, cfg) for s in shapes)
    return (total + batch_tiles - 1) // batch_tiles


_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.int32): torch.int32}


def pinned_empty(shape, dtype) -> np.ndarray:
    """An uninitialised numpy array over page-locked host memory from
    PyTorch's caching host allocator (``alloc`` for `iter_tile_batches`).

    The array's ``base`` is the pinned tensor, which `Prefetcher` stages
    from, so a ``non_blocking`` copy records its event with the allocator
    and the buffer is not handed out again before the copy has read it.
    """
    return torch.empty(tuple(shape), dtype=_TORCH_DTYPES[np.dtype(dtype)],
                       pin_memory=True).numpy()


def _pack(tiles: List[np.ndarray], headers: List[Tuple], cfg: DifetConfig,
          batch_tiles: int, alloc: Callable) -> TileBundle:
    """One fixed-shape batch, packed into ``alloc``'s arrays: the tiles
    stacked in place, the rows past them empty tiles with the pad flag set
    (`TileBundle.pad_to`'s values)."""
    n = len(tiles)
    out_t = alloc((batch_tiles,) + tiles[0].shape, np.float32)
    out_h = alloc((batch_tiles, 6), np.int32)
    np.stack(tiles, out=out_t[:n])
    out_h[:n] = headers
    out_t[n:] = 0
    out_h[n:] = 0
    out_h[n:, 5] = 1
    return TileBundle(out_t, out_h, cfg)


def iter_tile_batches(readers: Sequence[SceneReader], cfg: DifetConfig,
                      batch_tiles: int,
                      stripe_rows: Optional[int] = None,
                      start: int = 0, stop: Optional[int] = None,
                      alloc: Callable = np.empty
                      ) -> Iterator[Tuple[int, TileBundle]]:
    """Pack a scene sequence into fixed-shape `TileBundle` batches.

    Tiles stream scene by scene (scene_id = position in ``readers``) in
    `bundle_scenes` order; batch *i* holds flat tiles
    ``[i*batch_tiles, (i+1)*batch_tiles)`` of that order, the final partial
    batch padded to shape with pad-flagged empty tiles, which the engine
    masks out.  Fixed shapes let one extractor serve every batch, and the
    batch index is the manifest work item a worker owns.

    ``start``/``stop`` select the contiguous batch slice ``[start, stop)``,
    a worker's share of the manifest.  Scenes contributing no tile to the
    slice are skipped without reading a pixel (their tile counts come from
    header arithmetic), and reading stops once the slice is complete.
    ``alloc(shape, dtype)`` returns the arrays each batch's tiles and
    headers are packed into (`pinned_empty` packs straight into pinned
    memory).  Yields ``(batch_index, bundle)`` pairs.
    """
    if batch_tiles <= 0:
        raise ValueError(f"batch_tiles must be positive, got {batch_tiles}")
    n_batches = count_batches([r.shape for r in readers], cfg, batch_tiles)
    stop = n_batches if stop is None else min(stop, n_batches)
    if start < 0 or start > stop:
        raise ValueError(f"bad batch slice [{start}, {stop})")
    tiles: List[np.ndarray] = []
    headers: List[Tuple] = []
    flat = 0                       # global flat tile index
    for sid, reader in enumerate(readers):
        n_s = scene_tile_count(reader.shape, cfg)
        first_b = flat // batch_tiles
        last_b = (flat + n_s - 1) // batch_tiles
        if last_b < start or first_b >= stop:
            flat += n_s            # scene wholly outside the slice: no IO
            continue
        for tile, header in iter_scene_tiles(reader, cfg, sid, stripe_rows):
            if start <= flat // batch_tiles < stop:
                tiles.append(tile)
                headers.append(header)
                if len(tiles) == batch_tiles:
                    yield (flat // batch_tiles,
                           _pack(tiles, headers, cfg, batch_tiles, alloc))
                    tiles, headers = [], []
            flat += 1
            if stop < n_batches and flat >= stop * batch_tiles:
                # slice complete mid-scene: every batch before `stop` is
                # full and already yielded, so read no further stripe
                return
    if tiles:                      # the globally-last batch, pad-flagged
        yield (flat // batch_tiles,
               _pack(tiles, headers, cfg, batch_tiles, alloc))


def batch_slices(n_batches: int, n_workers: int) -> List[Tuple[int, int]]:
    """Contiguous near-even ``[lo, hi)`` batch slices, one per worker: the
    restart-deterministic partition (the same inputs give the same slices,
    and any worker count covers every batch exactly once)."""
    bounds = np.linspace(0, n_batches, n_workers + 1).astype(int)
    return [(int(bounds[i]), int(bounds[i + 1])) for i in range(n_workers)]


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """The tensor ``a`` is a whole view of (as `pinned_empty` returns),
    else a tensor over ``a``'s memory."""
    base = a.base
    if (isinstance(base, torch.Tensor) and tuple(base.shape) == a.shape
            and base.data_ptr() == a.ctypes.data):
        return base
    return torch.from_numpy(np.ascontiguousarray(a))


class Prefetcher:
    """Host prefetch queue with optional device staging.

    Wraps any iterator in a daemon thread and a bounded queue.  With
    ``depth=2`` (the default) this is double buffering: while the consumer
    computes on batch *i*, the thread is already tiling and reading batch
    *i+1* and, with ``device_put=True``, copying it to the device.

    Error contract: an exception in the producer (a truncated scene
    mid-stream, a failed copy) is captured, the thread exits, and the
    exception re-raises in the consumer at the failed batch.  ``close()``
    (or ``with``) shuts the thread down promptly even if the consumer
    abandons iteration early: the producer never blocks forever on a full
    queue.

    Staging (``device_put=True``): ``device=None`` means the CUDA card
    (`core/engine.py::resolve_device`, which raises on a host without CUDA;
    nothing is staged quietly onto the CPU); ``device="cpu"`` stages into
    CPU tensors.  ``TileBundle``s (bare or inside a yielded tuple, as
    `iter_tile_batches` yields them) stage tiles and headers; numpy arrays
    stage as tensors; other items (batch indices) pass through.  On the
    card the producer copies from pinned host memory (the arrays' own when
    they were packed by `pinned_empty`, else a pinned copy) with
    ``non_blocking`` copies on a stream of its own and records an event;
    ``__next__`` makes the consumer's current stream wait on that event and
    marks the staged tensors as used on it (``record_stream``) before it
    hands the batch over, so work queued on the consumer's stream never
    reads a half-copied batch.

    Staging over a mesh (``device_put=True, mesh=``, instead of
    ``device``): each array becomes a `Sharded` batch, its rows cut by
    `split_rows` and each slice copied from the pinned buffer straight to
    its entry's card, on a copy stream per card; ``__next__`` makes the
    consumer's stream on each card wait on that card's event and marks
    each slice as used there.  No card holds the whole batch.  On a CPU
    mesh the slices are views of the host batch.
    """

    _DONE = object()

    def __init__(self, it: Iterable, depth: int = 2,
                 device_put: bool = False, device=None,
                 mesh: Optional[Mesh] = None):
        if depth <= 0:
            raise ValueError(f"depth must be positive, got {depth}")
        if mesh is not None and device is not None:
            raise ValueError("stage onto a device or a mesh, not both")
        self._mesh = mesh if device_put else None
        self._device = (resolve_device(device)
                        if device_put and mesh is None else None)
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device is not None
                        and self._device.type == "cuda" else None)
        self._mesh_streams = (
            {d: torch.cuda.Stream(d) for d in dict.fromkeys(self._mesh)}
            if self._mesh is not None and self._mesh.type == "cuda" else {})
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._produce, args=(iter(it),), daemon=True,
            name="difet-prefetch")
        self._thread.start()

    def _stage_array(self, a: np.ndarray, staged: List):
        t = _host_tensor(a)
        if self._mesh is not None:
            return self._stage_sharded(t, staged)
        if self._stream is not None:
            if not t.is_pinned():
                t = t.pin_memory()
            t = t.to(self._device, non_blocking=True)
            staged.append((self._device, t))
        return t

    def _stage_sharded(self, t: torch.Tensor, staged: List) -> Sharded:
        if self._mesh_streams and not t.is_pinned():
            t = t.pin_memory()
        parts = []
        for dev, (lo, hi) in zip(self._mesh, split_rows(len(t), self._mesh)):
            part = t[lo:hi]
            if self._mesh_streams:
                with torch.cuda.stream(self._mesh_streams[dev]):
                    part = part.to(dev, non_blocking=True)
                staged.append((dev, part))
            parts.append(part)
        return Sharded(parts, self._mesh)

    def _stage_one(self, x, staged):
        if isinstance(x, TileBundle):
            return TileBundle(self._stage_array(x.tiles, staged),
                              self._stage_array(x.headers, staged), x.cfg)
        if isinstance(x, np.ndarray):
            return self._stage_array(x, staged)
        return x

    def _stage(self, item):
        """``(item, events, staged)``: the item with its arrays on the
        device (or the mesh) and, on the card, each copy stream's
        ``(device, event)`` after its copies, and the ``(device, tensor)``
        copies (``torch.cuda.stream(None)`` is a no-op)."""
        if self._device is None and self._mesh is None:
            return item, (), ()
        staged: List = []
        with torch.cuda.stream(self._stream):
            out = (tuple(self._stage_one(x, staged) for x in item)
                   if isinstance(item, tuple)
                   else self._stage_one(item, staged))
        streams = dict(self._mesh_streams)
        if self._stream is not None:
            streams[self._device] = self._stream
        events = []
        for dev, stream in streams.items():
            event = torch.cuda.Event()
            event.record(stream)
            events.append((dev, event))
        return out, events, staged

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, it):
        try:
            for item in it:
                if not self._put(self._stage(item)):
                    return                      # consumer closed early
        except BaseException as e:  # noqa: BLE001 (re-raised by the consumer)
            self._error = e
        self._put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                got = self._q.get(timeout=0.05)
            except queue.Empty:
                if not self._thread.is_alive() and self._q.empty():
                    # producer died without a sentinel (should not happen)
                    raise StopIteration
                continue
            if got is self._DONE:
                if self._error is not None:
                    err, self._error = self._error, None
                    raise err
                raise StopIteration
            item, events, staged = got
            for dev, event in events:
                consumer = torch.cuda.current_stream(dev)
                consumer.wait_event(event)
                for d, t in staged:
                    if d == dev:
                        t.record_stream(consumer)
            return item

    def close(self):
        """Stop the producer thread and drop queued batches."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
