"""DIFET execution engine: the paper's map and reduce over a tile batch.

Paper (Hadoop)                      Here (PyTorch)
--------------                      -----------------------------------------
HIB bundle in HDFS                  TileBundle, moved to the device
mapper per image                    batched per-tile extractor over [N, H, W]
  (decode→gray→detect→describe)       (detect → NMS → top-K → describe)
reduce (collect outputs)            count sum + global top-K merge

Port of ``repro/core/engine.py``.  The map runs on the whole ``[N, H, W]``
bundle at once (the reference's ``vmap`` written out).  With
``use_kernels=True``, the entry points' default, the response maps and blurs
go through the CUDA kernels (on a CPU tensor, through their plain twins),
mirroring ``use_pallas``; ``use_kernels=False`` is the reference's plain
route.

Spans (`obs/trace.py::span`, layer ``engine``; no-ops unless the flight
recorder or a ``torch.profiler`` is on): ``difet.extract`` around an entry
point's (or a mesh run's) map and reduces, ``difet.map``,
``difet.response.<fn>`` once per distinct response (``fn`` one of harris,
shi_tomasi, fast, sift, surf: BRIEF and ORB reuse FAST's),
``difet.select.<alg>`` (mask, count, NMS, top-K, scene coordinates),
``difet.describe.<alg>`` and ``difet.reduce.<alg>`` (attribute ``stage``:
``one``, ``requests``, ``local`` or ``merge``).
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.difet_paper import DifetConfig
from repro_torch.core import descriptors as DS
from repro_torch.core import detectors as D
from repro_torch.core import nms
from repro_torch.obs.trace import span


class AlgorithmSpec(NamedTuple):
    """One detector/descriptor algorithm as the engine consumes it.

    Fields:
        response:  ``(img [N,H,W], cfg, use_kernels) -> [N,H,W]`` dense
            response map (algorithms sharing a response function share its
            computation, see `extract_tile_multi`).
        describe:  ``(img [N,H,W], ys [N,K], xs [N,K], use_kernels) ->
            [N,K,D]``, or ``None`` for detector-only algorithms.
        threshold: ``cfg -> float`` absolute response threshold applied to
            the dense map before counting/top-K selection.
    """
    response: Callable
    describe: Optional[Callable]
    threshold: Callable


def _harris_resp(img, cfg, use_kernels):
    return D.harris_response(img, k=cfg.harris_k, use_kernels=use_kernels)


def _shi_resp(img, cfg, use_kernels):
    return D.shi_tomasi_response(img, use_kernels=use_kernels)


def _fast_resp(img, cfg, use_kernels):
    return D.fast_score(img, threshold=cfg.fast_threshold, arc=cfg.fast_arc,
                        use_kernels=use_kernels)


def _sift_resp(img, cfg, use_kernels):
    # the octave-0 (full-res) extrema map drives keypoints; OpenCV divides
    # the nominal contrast threshold by scales_per_octave — mirrored here.
    # Only octave 0 is computed: octave 0 never depends on the octaves after
    # it, and no result reads them (the reference's jit drops them as dead
    # code; the eager port would compute them), so cfg.n_octaves is not
    # passed.
    return D.sift_dog_response(
        img, 1, cfg.scales_per_octave,
        cfg.sift_contrast_threshold / cfg.scales_per_octave,
        use_kernels=use_kernels)[0]


def _surf_resp(img, cfg, use_kernels):
    return D.surf_hessian_response(img, use_kernels=use_kernels)


# paper thresholds are on 8-bit images; ours are [0,1] — rescaled where the
# response is quadratic in intensity (hessian/structure-tensor) vs linear.
ALGORITHMS: Dict[str, AlgorithmSpec] = {
    "harris": AlgorithmSpec(_harris_resp, None,
                            lambda c: c.harris_threshold * 1e-4),
    "shi_tomasi": AlgorithmSpec(_shi_resp, None,
                                lambda c: c.shi_tomasi_threshold * 1e-2),
    "sift": AlgorithmSpec(_sift_resp, DS.sift_descriptors,
                          lambda c: c.sift_contrast_threshold
                          / c.scales_per_octave),
    "surf": AlgorithmSpec(_surf_resp, DS.surf_descriptors,
                          lambda c: c.surf_hessian_threshold / 255.0 ** 2),
    "fast": AlgorithmSpec(_fast_resp, None, lambda c: 0.0),
    "brief": AlgorithmSpec(_fast_resp, DS.brief_descriptors,
                           lambda c: 0.0),
    "orb": AlgorithmSpec(_fast_resp, DS.orb_descriptors, lambda c: 0.0),
}


# the span name of each response function
_RESPONSE_NAMES = {_harris_resp: "harris", _shi_resp: "shi_tomasi",
                  _fast_resp: "fast", _sift_resp: "sift", _surf_resp: "surf"}


def normalize_algorithms(spec) -> tuple:
    """Canonicalize an algorithm selection: accepts a comma-separated string
    or a sequence of names, strips whitespace, drops duplicates (first
    occurrence wins), and rejects unknown names with the valid choices
    spelled out."""
    names = spec.split(",") if isinstance(spec, str) else list(spec)
    valid = ", ".join(sorted(ALGORITHMS))
    out = []
    for raw in names:
        name = raw.strip()
        if not name:
            continue
        if name not in ALGORITHMS:
            raise ValueError(
                f"unknown algorithm {name!r}; valid choices: {valid}")
        if name not in out:
            out.append(name)
    if not out:
        raise ValueError(f"no algorithms selected; valid choices: {valid}")
    return tuple(out)


def _select_and_describe(alg: str, cfg: DifetConfig, tiles, headers, resp,
                         use_kernels: bool):
    """NMS → capacity-K selection → describe for the algorithm ``alg``,
    given a precomputed response map [N,H,W], so algorithms sharing a
    response compute it once."""
    spec = ALGORITHMS[alg]
    attrs = dict(tiles=tiles.shape[0], k=cfg.max_keypoints_per_tile)
    with span(f"difet.select.{alg}", "engine", **attrs):
        thr = float(np.float32(spec.threshold(cfg)))
        not_pad = headers[:, 5] == 0
        mask = nms.interior_mask(resp.shape[-2:], cfg.halo, headers[:, 3],
                                 headers[:, 4]) & not_pad[:, None, None]
        count = nms.count_above(resp, thr, mask)
        resp_nms = nms.nms3x3(resp)
        ys, xs, scores, valid = nms.topk_keypoints(
            resp_nms, cfg.max_keypoints_per_tile, thr, mask)
        out = {"count": count, "scores": scores, "valid": valid}
        # global scene coordinates (interior-relative)
        out["ys"] = headers[:, 1:2] * cfg.tile + (ys - cfg.halo)
        out["xs"] = headers[:, 2:3] * cfg.tile + (xs - cfg.halo)
    if spec.describe is not None:
        with span(f"difet.describe.{alg}", "engine", **attrs):
            desc = spec.describe(tiles, ys, xs, use_kernels)
            out["desc"] = torch.where(valid[..., None], desc,
                                      torch.zeros_like(desc))
    return out


def extract_tile(algorithm: str, cfg: DifetConfig, tile: torch.Tensor,
                 header: torch.Tensor, use_kernels: bool = True):
    """The DIFET 'map function' for one tile [H, W] and its header (the
    paper's pseudo-code: detect, describe, emit): a dict of fixed-shape
    features, as `extract_tile_multi` gives them for a batch of one."""
    out = extract_tile_multi((algorithm,), cfg, tile[None], header[None],
                             use_kernels)[algorithm]
    return {k: v[0] for k, v in out.items()}


def iter_tile_multi(algorithms, cfg: DifetConfig, tiles: torch.Tensor,
                    headers: torch.Tensor, use_kernels: bool = True):
    """`extract_tile_multi` one algorithm at a time: yields ``(algorithm,
    features)`` in order, so that a caller can interleave the maps of
    several devices (`make_distributed_extractor`'s round-robin issue).
    Every span opened here closes before the ``yield``: the caller may
    step other generators in between."""
    resp_cache = {}
    for alg in algorithms:
        fn = ALGORITHMS[alg].response
        if fn not in resp_cache:
            with span(f"difet.response.{_RESPONSE_NAMES[fn]}", "engine",
                      tiles=tiles.shape[0], k=cfg.max_keypoints_per_tile):
                resp_cache[fn] = fn(tiles, cfg, use_kernels)
        feats = _select_and_describe(alg, cfg, tiles, headers, resp_cache[fn],
                                     use_kernels)
        yield alg, feats


def extract_tile_multi(algorithms, cfg: DifetConfig, tiles: torch.Tensor,
                       headers: torch.Tensor, use_kernels: bool = True):
    """The per-tile map for several algorithms over a batch [N,H,W],
    computing each distinct response function ONCE: ``fast``/``brief``/
    ``orb`` share the FAST score map.  Returns {algorithm: features}, each
    feature batched over the N tiles."""
    return dict(iter_tile_multi(algorithms, cfg, tiles, headers,
                                use_kernels))


def _reduce(fn, stage: str, alg: str, *args):
    """``fn(*args)``, one of the reduces, under the span
    ``difet.reduce.<alg>``."""
    with span(f"difet.reduce.{alg}", "engine", stage=stage):
        return fn(*args)


def _reduce_features(per_tile):
    """The reduce: total count + global top-K merge (ties toward the
    smaller flat index, as ``lax.top_k``)."""
    total = per_tile["count"].sum()
    t, k = per_tile["scores"].shape
    flat_scores = per_tile["scores"].reshape(t * k)
    flat_valid = per_tile["valid"].reshape(t * k)
    masked = torch.where(flat_valid, flat_scores,
                         torch.full_like(flat_scores, float("-inf")))
    top_scores, idx = nms.stable_topk(masked, min(k * 4, t * k))
    finite = torch.isfinite(top_scores)

    def gather(a):
        return a.reshape(t * k, *a.shape[2:])[idx]

    result = {
        "total_count": total,
        "per_tile_count": per_tile["count"],
        "top_scores": torch.where(finite, top_scores,
                                  torch.zeros_like(top_scores)),
        "top_ys": gather(per_tile["ys"]),
        "top_xs": gather(per_tile["xs"]),
        "top_valid": gather(per_tile["valid"]) & finite,
        "keypoint_count": per_tile["valid"].sum(),
    }
    if "desc" in per_tile:
        result["top_desc"] = gather(per_tile["desc"])
    return result


def _local_reduce(per_tile):
    """The first stage of the two-stage reduce, on one mesh entry's tiles:
    the entry's own stable top ``min(4k, t_i k)`` of its masked flat
    scores (invalid slots at -inf, kept as -inf) with the keypoints, flags
    and descriptors gathered at them, its per-tile counts and its
    keypoint count.  See `merge_reduced`."""
    t, k = per_tile["scores"].shape
    flat_scores = per_tile["scores"].reshape(t * k)
    flat_valid = per_tile["valid"].reshape(t * k)
    masked = torch.where(flat_valid, flat_scores,
                         torch.full_like(flat_scores, float("-inf")))
    top_scores, idx = nms.stable_topk(masked, min(k * 4, t * k))

    def gather(a):
        return a.reshape(t * k, *a.shape[2:])[idx]

    out = {"per_tile_count": per_tile["count"],
           "keypoint_count": per_tile["valid"].sum(),
           "scores": top_scores, "ys": gather(per_tile["ys"]),
           "xs": gather(per_tile["xs"]), "valid": gather(per_tile["valid"])}
    if "desc" in per_tile:
        out["desc"] = gather(per_tile["desc"])
    return out


def merge_reduced(parts, k: int):
    """The second stage: ``parts`` are the `_local_reduce` results of
    contiguous tile slices, in slice order, all on one device.  Equal, bit
    for bit and dtype for dtype, to `_reduce_features` over the whole
    batch:

    * counts: the per-tile counts concatenate in tile order and are summed
      as one tensor, as the one-stage reduce sums them; keypoint counts are
      integers and add exactly.
    * top-K: the one-stage reduce keeps the first ``M = min(4k, t k)``
      slots in the order (score descending, flat index ascending).  A slot
      of entry i among them has fewer than M slots of entry i ahead of it
      in that order, so it is among entry i's own first ``min(4k, t_i k)``
      (M <= 4k, and the entry has t_i k slots): the candidates hold the
      whole answer, the -inf fill slots it needs included (at most
      ``4k - V`` of them, V the valid slots of all entries; each entry's
      list holds its own lowest-index ones).  Each entry's list is in that
      order; the slices are contiguous, so among equal scores the
      concatenation in slice order is flat-index order, and the stable
      top-M of the concatenation is the one-stage top-M.

    Only the candidates cross devices (``4k`` slots an entry; for SIFT
    ``4k x 128`` floats, not ``[t, k, 128]``)."""
    def cat(key):
        return torch.cat([p[key] for p in parts])

    per_tile_count = cat("per_tile_count")
    t = per_tile_count.shape[0]
    top_scores, idx = nms.stable_topk(cat("scores"), min(k * 4, t * k))
    finite = torch.isfinite(top_scores)
    result = {
        "total_count": per_tile_count.sum(),
        "per_tile_count": per_tile_count,
        "top_scores": torch.where(finite, top_scores,
                                  torch.zeros_like(top_scores)),
        "top_ys": cat("ys")[idx],
        "top_xs": cat("xs")[idx],
        "top_valid": cat("valid")[idx] & finite,
        "keypoint_count": torch.stack(
            [p["keypoint_count"] for p in parts]).sum(),
    }
    if "desc" in parts[0]:
        result["top_desc"] = cat("desc")[idx]
    return result


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card.  A CUDA device on a host without CUDA
    raises instead of quietly running on the CPU: pass ``device="cpu"`` to
    ask for the CPU.  A CUDA device always comes back with its index (a
    bare ``"cuda"`` is the calling thread's current card), so that it
    names one card from any thread."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available on this host; pass device='cpu' to "
                "run the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _map(bundle_tiles, bundle_headers, algorithms, cfg: DifetConfig,
         use_kernels: bool, device):
    """Run the map over the whole bundle at once on ``device``."""
    with span("difet.map", "engine"):
        dev = resolve_device(device)
        tiles = torch.as_tensor(bundle_tiles, dtype=torch.float32)
        headers = torch.as_tensor(bundle_headers, dtype=torch.int32)
        return extract_tile_multi(algorithms, cfg,
                                  tiles.to(dev).contiguous(),
                                  headers.to(dev), use_kernels)


def _extract_span(bundle_tiles, algorithms):
    """The ``difet.extract`` span of an entry point over ``[N, H, W]``."""
    n, h, w = bundle_tiles.shape
    return span("difet.extract", "engine", algorithms=",".join(algorithms),
                tiles=n, tile_hw=f"{h}x{w}")


def extract_features(bundle_tiles, bundle_headers, algorithm: str,
                     cfg: DifetConfig, use_kernels: bool = True,
                     device=None):
    """Map over tiles + the reduce: total count and global top-K.

    ``bundle_tiles`` [N,H,W] and ``bundle_headers`` [N,6] are numpy arrays
    or tensors; they run on ``device`` (the CUDA card unless
    ``device="cpu"``), all tiles at once.  By default the response maps and
    blurs go through the CUDA kernels (their plain twins on a CPU tensor);
    ``use_kernels=False`` takes the reference's plain ``use_pallas=False``
    route."""
    return extract_features_multi(bundle_tiles, bundle_headers, (algorithm,),
                                  cfg, use_kernels, device)[algorithm]


def extract_features_multi(bundle_tiles, bundle_headers, algorithms,
                           cfg: DifetConfig, use_kernels: bool = True,
                           device=None):
    """Multi-algorithm extraction with shared response maps: one map
    computes every requested algorithm per tile, then each algorithm gets
    its own reduce.  Arguments as `extract_features`.  Returns
    {algorithm: result}."""
    algorithms = tuple(algorithms)
    with _extract_span(bundle_tiles, algorithms):
        per_tile = _map(bundle_tiles, bundle_headers, algorithms, cfg,
                        use_kernels, device)
        return {alg: _reduce(_reduce_features, "one", alg, per_tile[alg])
                for alg in algorithms}


def _reduce_requests(per_tile):
    """The reduce with every batch row its own request: `_reduce_features`
    over each row's [1, K] candidates, for all rows at once.  Each row is
    stable-sorted on its own (invalid slots at -inf), so the result equals
    the per-row reduce bit for bit, dtypes included."""
    count, scores, valid = (per_tile["count"], per_tile["scores"],
                            per_tile["valid"])
    masked = torch.where(valid, scores,
                         torch.full_like(scores, float("-inf")))
    top_scores, idx = nms.stable_topk(masked, scores.shape[1])
    finite = torch.isfinite(top_scores)

    def gather(a):
        ix = idx.reshape(idx.shape + (1,) * (a.ndim - 2))
        return torch.gather(a, 1, ix.expand(idx.shape + a.shape[2:]))

    result = {
        # a one-element sum: the same value, promoted as ``.sum()`` does
        "total_count": count.to(torch.int64),
        "per_tile_count": count[:, None],
        "top_scores": torch.where(finite, top_scores,
                                  torch.zeros_like(top_scores)),
        "top_ys": gather(per_tile["ys"]),
        "top_xs": gather(per_tile["xs"]),
        "top_valid": gather(valid) & finite,
        "keypoint_count": valid.sum(dim=1),
    }
    if "desc" in per_tile:
        result["top_desc"] = gather(per_tile["desc"])
    return result


def extract_request_features(bundle_tiles, bundle_headers, algorithms,
                             cfg: DifetConfig, use_kernels: bool = True,
                             device=None):
    """Serving-path extraction: every batch row is an independent request,
    so the reduce runs per tile over its own [1, K] candidate set (all rows
    at once).  Arguments as `extract_features`.  Returns {algorithm:
    result} with a leading batch dim on every entry.  Each row's values
    depend on that row alone, so a request's result is bit-identical
    whatever batch it rode in."""
    algorithms = tuple(algorithms)
    with _extract_span(bundle_tiles, algorithms):
        per_tile = _map(bundle_tiles, bundle_headers, algorithms, cfg,
                        use_kernels, device)
        return {alg: _reduce(_reduce_requests, "requests", alg,
                             per_tile[alg])
                for alg in algorithms}


def make_serve_step(algorithms, cfg: DifetConfig, use_kernels: bool = True,
                    device=None):
    """The serving step of one (shape bucket, algorithm set) pair:
    ``step(tiles [B,H,W] f32, headers [B,6] i32) -> {alg: {key: tensor}}``
    with the inputs already on ``device`` (the card unless
    ``device="cpu"``).  It makes no host synchronization, so
    `serve/buckets.py::CompileCache` captures it once per pair as a CUDA
    graph at the scheduler's fixed batch shape and replays it.  Its spans
    (the engine's) therefore record at capture only: a replay runs no
    Python."""
    algorithms = tuple(algorithms)
    dev = resolve_device(device)

    def step(tiles: torch.Tensor, headers: torch.Tensor):
        return extract_request_features(tiles, headers, algorithms, cfg,
                                        use_kernels, dev)
    return step


def make_distributed_multi_extractor(algorithms, cfg: DifetConfig, mesh,
                                     use_kernels: bool = True):
    """The extractor over a data mesh (`distributed/sharding.py::Mesh`):
    ``run(tiles, headers) -> {algorithm: result}`` with every result on
    the mesh's first device, bit for bit `extract_features_multi`'s on the
    whole batch.

    The tiles and headers (numpy arrays, tensors on any device, or
    `Sharded` batches on ``mesh``, as `data/pipeline.py::Prefetcher(mesh=)`
    stages them) are cut into contiguous row slices in mesh order, each on
    its own entry's device (the split may be uneven; an entry without rows
    sits out).  Each entry runs the map and the first stage of the reduce
    (`_local_reduce`) on its own stream; only the candidates and the
    per-tile counts cross to the first device, where `merge_reduced` takes
    the count sum and the global top-K (see its docstring for why that is
    the one-stage reduce).  Everything per tile stays on its entry's card.
    The calling thread issues the entries' work in turn (`MeshRunner`).
    Every mesh runs this split, one of one entry too; the jobs and the
    sweep send such a mesh to the one-device code instead
    (`distributed/sharding.py::one_device`)."""
    from repro_torch.distributed.sharding import MeshRunner, shard
    algorithms = tuple(algorithms)
    k = cfg.max_keypoints_per_tile
    runner = MeshRunner(mesh)

    def run(tiles, headers):
        with _extract_span(tiles, algorithms):
            tiles = shard(tiles, mesh, torch.float32)
            headers = shard(headers, mesh, torch.int32)
            entries = [i for i, p in enumerate(tiles.parts) if len(p)] or [0]

            def work(i):
                for alg, feats in iter_tile_multi(
                        algorithms, cfg, tiles.parts[i], headers.parts[i],
                        use_kernels):
                    local = _reduce(_local_reduce, "local", alg, feats)
                    yield alg, local

            parts = runner.run(work, entries)
            return {alg: _reduce(merge_reduced, "merge", alg,
                                 [p[alg] for p in parts], k)
                    for alg in algorithms}

    return run


def make_distributed_extractor(algorithm: str, cfg: DifetConfig, mesh,
                               use_kernels: bool = True):
    """`make_distributed_multi_extractor` for one algorithm:
    ``run(tiles, headers) -> result``, bit for bit `extract_features`."""
    run_multi = make_distributed_multi_extractor((algorithm,), cfg, mesh,
                                                 use_kernels)

    def run(tiles, headers):
        return run_multi(tiles, headers)[algorithm]

    return run
