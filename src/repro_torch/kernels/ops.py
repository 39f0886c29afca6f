"""Public wrappers of the CUDA kernels (``repro/kernels/ops.py``'s
counterparts): ``harris``, ``gaussian_blur``, ``fast_score`` and
``scalespace_octave`` accept ``[H, W]`` or ``[N, H, W]`` (the blur any
``[..., H, W]``) and return the same rank.  The kernels reflect-pad by index
themselves, so the reference's host-side pad and its TPU-only 128-lane edge
pad have no counterpart here; neither changes the cropped output.

``select_keypoints`` is the per-tile keypoint selection of response maps
(NMS, ownership, the exact count and the stable top-K).

``match_best2`` is the descriptor matcher; its kernel masks its own ragged
query and database edges, so the reference's zero-padding of D to 128 lanes
and of the queries to ``QBLOCK`` has no counterpart either.
"""
from __future__ import annotations

import functools
import time

import torch

from repro_torch.kernels import blur as _blur
from repro_torch.kernels import dispatch as _dispatch
from repro_torch.kernels import fastscore as _fast
from repro_torch.kernels import harris as _harris
from repro_torch.kernels import matcher as _matcher
from repro_torch.kernels import ref
from repro_torch.kernels import scalespace as _scalespace
from repro_torch.kernels import select as _select
from repro_torch.obs import profile as _obs_profile

KERNELS = {
    "harris": _harris.KERNEL,
    "fast": _fast.KERNEL,
    "blur": _blur.KERNEL,
    "scalespace": _scalespace.KERNEL,
    "matcher": _matcher.KERNEL,
    "select": _select.KERNEL,
}


def launch_counts() -> dict:
    """{kernel name: launches so far} for every kernel."""
    return {name: k.launches for name, k in KERNELS.items()}


def launch_counts_by_device() -> dict:
    """{kernel name: {CUDA device index: launches so far}}."""
    return {name: dict(k.launches_by_device) for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.reset()


def _as3d(img: torch.Tensor):
    x = img.reshape((-1,) + tuple(img.shape[-2:])).float().contiguous()
    return x, lambda out: out.reshape(img.shape)


def harris(img: torch.Tensor, *, k: float = 0.04, sigma: float = 1.0,
           shi_tomasi: bool = False) -> torch.Tensor:
    """Fused Harris / Shi-Tomasi response.  img [H,W] or [N,H,W] -> same."""
    x, back = _as3d(img)
    return back(_harris.harris(x, k=k, sigma=sigma, shi_tomasi=shi_tomasi))


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur.  img [..., H, W] (leading dims flattened)."""
    x, back = _as3d(img)
    return back(_blur.blur(x, sigma))


def fast_score(img: torch.Tensor, *, threshold: float = 0.15,
               arc: int = 9) -> torch.Tensor:
    """FAST-N corner score.  img [H,W] or [N,H,W] -> same."""
    x, back = _as3d(img)
    return back(_fast.fast_score(x, threshold=threshold, arc=arc))


def scalespace_octave(base: torch.Tensor, *, scales_per_octave: int,
                      contrast_threshold: float, sigma0: float = 1.6):
    """Fused SIFT octave: (extrema response, next-octave seed level).
    ``base`` [H,W] or [N,H,W], already blurred to ``sigma0``."""
    x, back = _as3d(base)
    resp, seed = _scalespace.scalespace_octave(
        x, scales_per_octave=scales_per_octave,
        contrast_threshold=contrast_threshold, sigma0=sigma0)
    return back(resp), back(seed)


def scalespace_pad(scales_per_octave: int, sigma0: float = 1.6) -> int:
    """The fused octave's one-time padding: cumulative blur radius + 1."""
    return sum((len(t) - 1) // 2
               for t in ref.scalespace_taps(scales_per_octave, sigma0)) + 1


select_keypoints = _select.select_keypoints


# The JAX reference's octave-fusion rule, byte for byte
# (repro/kernels/ops.py::scalespace_fits_vmem, a 12 MiB TPU VMEM budget with
# 128-lane alignment).  Kept so that the port computes the same maps as the
# reference; it is not a limit of this card.
_REFERENCE_LANE = 128
_REFERENCE_BUDGET_BYTES = 12 * 2 ** 20


def reference_fuses_octave(h: int, w: int, scales_per_octave: int,
                           sigma0: float = 1.6) -> bool:
    """True where the reference runs an ``[h, w]`` SIFT octave through its
    fused pad-once kernel; elsewhere it runs the per-level path."""
    p = scalespace_pad(scales_per_octave, sigma0)
    wp = w + 2 * p
    wp += (-wp) % _REFERENCE_LANE
    slab = (h + 2 * p) * wp * 4
    n_levels = scales_per_octave + 3
    return (2 * n_levels + 2 + 4) * slab <= _REFERENCE_BUDGET_BYTES


# --- descriptor matching -------------------------------------------------------
# As in the reference, a call with no pinned path asks the measured dispatch
# (`kernels/dispatch.py`): the first call of a (metric, backend, shape
# bucket) times every eligible path and keeps the fastest.  On the card the
# contest holds the kernel's two plans, and a torch formulation runs there
# only when the caller asks for it: ``cuda_resident`` launches the kernel
# with one segment (each query tile's block scans the whole database, the
# reference's resident kernel), ``cuda_stream`` with ``matcher.plan``'s
# segments (its streaming kernel), which keeps a bucket unless one segment
# is ``dispatch.SWITCH_MARGIN`` times faster.  The reference's 12 MiB TPU
# VMEM rule for its resident kernel (matcher_fits_vmem) is not copied: it
# picks a path, not a result.
MATCH_QBLOCK = _matcher.QBLOCK
FULL_MAX_ROWS = _dispatch.FULL_MAX_ROWS
MATCH_PATHS = _dispatch.MATCH_PATHS
shape_bucket = _dispatch.shape_bucket


def match_path(nq: int, nk: int, d: int, *, metric: str = "l2",
               use_kernels: bool = None, backend: str = None,
               device=None) -> str:
    """Resolve which implementation a ``match_best2`` call of this shape
    takes, one of ``MATCH_PATHS`` (`kernels/dispatch.py::choose_path`).

    ``use_kernels=True`` is the measured contest of the kernel's two plans
    (on the CPU: ``cuda_stream``, whose wrapper runs its twin there);
    ``use_kernels=False`` that of the torch formulations; ``None`` (the
    default) lets the per-(metric, backend, shape bucket) microbenchmark
    decide among the backend's own: the kernel's plans on the card, the
    torch formulations on the CPU.  ``backend`` is the tensors' device type
    (default: ``device``'s, else ``cuda`` where the card is present) and
    ``device`` the one the probes run on."""
    return _dispatch.choose_path(metric, nq, nk, d, backend=backend,
                                 use_kernels=use_kernels, device=device)


# ``match_best2`` makes the dtypes and contiguity that ``matcher.match``
# checks, so its CUDA paths go straight to the launch
_PATH_FNS = {
    "torch_full": _matcher.best2_full,
    "torch_stream": _matcher.best2_stream,
    "cuda_resident": functools.partial(_matcher.launch, segments=1),
    "cuda_stream": _matcher.launch,
}


def match_best2(queries: torch.Tensor, db: torch.Tensor,
                db_valid: torch.Tensor = None, *, metric: str = "l2",
                use_kernels: bool = None, path: str = None):
    """Per query (best, second-best, argbest) over a masked database.

    queries [Q, D], db [K, D], db_valid [K] (None = all valid), all on one
    device.  ``metric="hamming"`` needs bit-packed int32 words
    (``descriptors.pack_bits``) and gives exact int32 distances;
    ``metric="l2"`` needs floats (cast to fp32) and gives squared L2.
    ``path`` pins one of ``MATCH_PATHS``; otherwise ``match_path`` picks
    one, measured once per shape bucket (``use_kernels`` None: the
    backend's own, the kernel's two plans on the card and the torch paths
    on the CPU; True: the kernel's two plans; False: the torch paths).
    On CUDA tensors a CUDA path launches its kernel or raises.  Every path
    gives the same distances, masking and smallest-index ties, so the choice
    is a path, never a result: Hamming bit for bit on every path, L2 bit for
    bit between the kernel's two plans and within rtol 1e-5 / atol 1e-4
    between a torch path and the kernel.

    With the kernel profiler enabled (`obs/profile.py`), a call waits for
    its result and stamps its wall time under
    ``match:<metric>:<path>:q<Q>k<K>d<D>`` (`shape_bucket`); disabled, the
    call makes no synchronization."""
    if metric == "hamming":
        if queries.dtype != torch.int32 or db.dtype != torch.int32:
            raise TypeError("hamming matching needs bit-packed int32 "
                            "descriptors (descriptors.pack_bits)")
    elif metric == "l2":
        if not (queries.is_floating_point() and db.is_floating_point()):
            raise TypeError("l2 matching needs float descriptors")
        queries, db = queries.float(), db.float()
    else:
        raise ValueError(f"unknown metric {metric!r}")
    nk = db.shape[0]
    if db_valid is None:
        db_valid = torch.ones(nk, dtype=torch.int32, device=db.device)
    elif (db_valid.dtype != torch.int32
          or db_valid.get_device() != db.get_device()):
        db_valid = db_valid.to(device=db.device, dtype=torch.int32)
    db_valid = db_valid.contiguous()
    if path is not None and path not in MATCH_PATHS:
        raise ValueError(f"unknown path {path!r} (want one of {MATCH_PATHS})")
    queries, db = queries.contiguous(), db.contiguous()
    _matcher.check_shapes(queries, db, db_valid, metric, "match_best2")
    if path is None:
        path = match_path(queries.shape[0], nk, queries.shape[1],
                          metric=metric, use_kernels=use_kernels,
                          device=queries.device)
    prof = _obs_profile.profiler()
    if not prof.enabled:
        return _PATH_FNS[path](queries, db, db_valid, metric=metric)
    qb, kb, d = shape_bucket(queries.shape[0], nk, queries.shape[1])
    t0 = time.monotonic()
    out = _PATH_FNS[path](queries, db, db_valid, metric=metric)
    if queries.device.type == "cuda":
        torch.cuda.synchronize(queries.device)   # the work on the clock
    prof.record_call(f"match:{metric}:{path}:q{qb}k{kb}d{d}",
                     time.monotonic() - t0)
    return out
