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
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.difet_paper import DifetConfig
from repro_torch.core import descriptors as DS
from repro_torch.core import detectors as D
from repro_torch.core import nms


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
    # the nominal contrast threshold by scales_per_octave — mirrored here
    return D.sift_dog_response(
        img, cfg.n_octaves, cfg.scales_per_octave,
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


def _select_and_describe(spec: AlgorithmSpec, cfg: DifetConfig, tiles,
                         headers, resp, use_kernels: bool):
    """NMS → capacity-K selection → describe, given a precomputed response
    map [N,H,W], so algorithms sharing a response compute it once."""
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
        desc = spec.describe(tiles, ys, xs, use_kernels)
        out["desc"] = torch.where(valid[..., None], desc,
                                  torch.zeros_like(desc))
    return out


def extract_tile_multi(algorithms, cfg: DifetConfig, tiles: torch.Tensor,
                       headers: torch.Tensor, use_kernels: bool = True):
    """The per-tile map for several algorithms over a batch [N,H,W],
    computing each distinct response function ONCE: ``fast``/``brief``/
    ``orb`` share the FAST score map.  Returns {algorithm: features}, each
    feature batched over the N tiles."""
    resp_cache = {}
    out = {}
    for alg in algorithms:
        spec = ALGORITHMS[alg]
        if spec.response not in resp_cache:
            resp_cache[spec.response] = spec.response(tiles, cfg, use_kernels)
        out[alg] = _select_and_describe(spec, cfg, tiles, headers,
                                        resp_cache[spec.response],
                                        use_kernels)
    return out


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


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card.  A CUDA device on a host without CUDA
    raises instead of quietly running on the CPU: pass ``device="cpu"`` to
    ask for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    return dev


def _map(bundle_tiles, bundle_headers, algorithms, cfg: DifetConfig,
         use_kernels: bool, device):
    """Run the map over the whole bundle at once on ``device``."""
    dev = resolve_device(device)
    tiles = torch.as_tensor(bundle_tiles, dtype=torch.float32)
    headers = torch.as_tensor(bundle_headers, dtype=torch.int32)
    return extract_tile_multi(algorithms, cfg, tiles.to(dev).contiguous(),
                              headers.to(dev), use_kernels)


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
    per_tile = _map(bundle_tiles, bundle_headers, algorithms, cfg,
                    use_kernels, device)
    return {alg: _reduce_features(per_tile[alg]) for alg in algorithms}


def extract_request_features(bundle_tiles, bundle_headers, algorithms,
                             cfg: DifetConfig, use_kernels: bool = True,
                             device=None):
    """Serving-path extraction: every batch row is an independent request,
    so the reduce runs per tile over its own [1, K] candidate set.
    Arguments as `extract_features`.  Returns {algorithm: result} with a
    leading batch dim on every entry."""
    algorithms = tuple(algorithms)
    per_tile = _map(bundle_tiles, bundle_headers, algorithms, cfg,
                    use_kernels, device)
    out = {}
    for alg in algorithms:
        feats = per_tile[alg]
        rows = [_reduce_features({key: v[i:i + 1] for key, v in feats.items()})
                for i in range(feats["count"].shape[0])]
        out[alg] = {key: torch.stack([r[key] for r in rows])
                    for key in rows[0]}
    return out
