"""Public wrappers of the CUDA kernels (``repro/kernels/ops.py``'s
counterparts): ``harris``, ``gaussian_blur``, ``fast_score`` and
``scalespace_octave`` accept ``[H, W]`` or ``[N, H, W]`` (the blur any
``[..., H, W]``) and return the same rank.  The kernels reflect-pad by index
themselves, so the reference's host-side pad and its TPU-only 128-lane edge
pad have no counterpart here; neither changes the cropped output.

``match_best2`` is the descriptor matcher; its kernel masks its own ragged
query and database edges, so the reference's zero-padding of D to 128 lanes
and of the queries to ``QBLOCK`` has no counterpart either.
"""
from __future__ import annotations

import time

import torch

from repro_torch.kernels import blur as _blur
from repro_torch.kernels import fastscore as _fast
from repro_torch.kernels import harris as _harris
from repro_torch.kernels import matcher as _matcher
from repro_torch.kernels import ref
from repro_torch.kernels import scalespace as _scalespace
from repro_torch.obs import profile as _obs_profile

KERNELS = {
    "harris": _harris.KERNEL,
    "fast": _fast.KERNEL,
    "blur": _blur.KERNEL,
    "scalespace": _scalespace.KERNEL,
    "matcher": _matcher.KERNEL,
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
# The reference measures its paths once per shape bucket and may pick a jnp
# path on any backend; it also gates its resident kernel on a 12 MiB TPU
# VMEM budget (matcher_fits_vmem).  Both pick a path, not a result, so
# neither is copied (unlike the octave-fusion rule above, which decides
# which maps the reference computes).  Here the card always runs the kernel,
# which sizes its own launch (``matcher.plan``), and the plain route is
# taken only when asked for.
MATCH_QBLOCK = _matcher.QBLOCK
FULL_MAX_ROWS = 1 << 17          # torch_full's [Q, K] block up to this K
# ``cuda_resident`` names the same kernel as ``cuda_stream``: one launch
# covers both of the reference's kernels
MATCH_PATHS = ("torch_full", "torch_stream", "cuda_resident", "cuda_stream")


def match_path(nk: int, *, use_kernels: bool = None,
               backend: str = None) -> str:
    """The path a ``match_best2`` call over ``nk`` database rows takes, one
    of ``MATCH_PATHS``.  ``backend`` is the tensors' device type (default:
    ``cuda`` where the card is present).  On ``cuda``, ``use_kernels`` None
    or True takes the kernel (``cuda_stream``); ``use_kernels=False``, or
    None on the CPU, takes the plain route: ``torch_full`` up to
    ``FULL_MAX_ROWS`` rows, ``torch_stream`` above.  ``use_kernels=True``
    on the CPU takes ``cuda_stream``, whose wrapper runs its twin there."""
    if backend is None:
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    if use_kernels or (use_kernels is None and backend == "cuda"):
        return "cuda_stream"
    return "torch_full" if nk <= FULL_MAX_ROWS else "torch_stream"


# ``match_best2`` makes the dtypes and contiguity that ``matcher.match``
# checks, so its CUDA paths go straight to the launch
_PATH_FNS = {
    "torch_full": _matcher.best2_full,
    "torch_stream": _matcher.best2_stream,
    "cuda_resident": _matcher.launch,
    "cuda_stream": _matcher.launch,
}


def _pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def shape_bucket(nq: int, nk: int, d: int):
    """(nq, nk) rounded up to powers of two, the width exact: the key a
    profiled ``match_best2`` call is stamped under (a copy of the
    reference's ``kernels/dispatch.py::shape_bucket``)."""
    return _pow2(max(nq, 1)), _pow2(max(nk, 1)), int(d)


def match_best2(queries: torch.Tensor, db: torch.Tensor,
                db_valid: torch.Tensor = None, *, metric: str = "l2",
                use_kernels: bool = None, path: str = None):
    """Per query (best, second-best, argbest) over a masked database.

    queries [Q, D], db [K, D], db_valid [K] (None = all valid), all on one
    device.  ``metric="hamming"`` needs bit-packed int32 words
    (``descriptors.pack_bits``) and gives exact int32 distances;
    ``metric="l2"`` needs floats (cast to fp32) and gives squared L2.
    ``path`` pins one of ``MATCH_PATHS``; otherwise ``match_path`` picks
    one from the database size and ``use_kernels``.  On CUDA tensors a
    CUDA path launches its kernel or raises; a torch path runs only when
    asked for (``use_kernels=False`` or ``path``).  Every path gives the
    same distances, masking and smallest-index ties (Hamming bit for
    bit).

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
    if path is None:
        path = match_path(nk, use_kernels=use_kernels,
                          backend=queries.device.type)
    elif path not in MATCH_PATHS:
        raise ValueError(f"unknown path {path!r} (want one of {MATCH_PATHS})")
    queries, db = queries.contiguous(), db.contiguous()
    _matcher.check_shapes(queries, db, db_valid, metric, "match_best2")
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
