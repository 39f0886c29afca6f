"""Keypoint selection: wrapper of ``csrc/select.cu``.

Replaces no Pallas kernel: the reference selects with ``lax.reduce_window``,
masks and ``lax.top_k`` (``repro/core/nms.py``).  On a CUDA tensor it
launches the kernel (a memset and two passes); on a CPU tensor it runs the
plain twin ``core/nms.py::select_keypoints``, the torch ops the kernel
replaced.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import nms
from repro_torch.kernels.build import CudaKernel, check_image

KERNEL = CudaKernel("select", "difet_select", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,   # resp, headers, stride
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,    # n, h, w
    ctypes.c_int, ctypes.c_float, ctypes.c_int,       # halo, threshold, k
    ctypes.c_longlong, ctypes.c_void_p,               # cap, keys
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # counts, ys, xs
    ctypes.c_void_p, ctypes.c_void_p,                 # scores, valid
])


def scratch_per_tile(h: int, w: int, halo: int, threshold: float) -> int:
    """Candidate keys a tile can hold: owned pixels lie in the last
    ``h - halo`` rows and ``w - halo`` columns; with a threshold >= 0 only
    NMS survivors pass, and no two touch (one in each 2 x 2 cell at most).
    A NaN threshold passes nothing; it takes the larger bound all the
    same."""
    oh, ow = max(h - max(halo, 0), 0), max(w - max(halo, 0), 0)
    if threshold >= 0:
        return ((oh + 1) // 2) * ((ow + 1) // 2)
    return oh * ow


def check_headers(headers: torch.Tensor, resp: torch.Tensor) -> None:
    """What the kernel takes as headers: int32 [N, >= 6], contiguous, on
    ``resp``'s device."""
    if headers.dtype != torch.int32:
        raise TypeError(f"select_keypoints: headers need int32, got "
                        f"{headers.dtype}")
    if headers.ndim != 2 or headers.shape[0] != resp.shape[0] \
            or headers.shape[1] < 6:
        raise ValueError(f"select_keypoints: headers need [N, 6] for N = "
                         f"{resp.shape[0]}, got {tuple(headers.shape)}")
    if not headers.is_contiguous():
        raise ValueError("select_keypoints: needs contiguous headers")
    if headers.device != resp.device:
        raise ValueError(f"select_keypoints: headers on {headers.device}, "
                         f"the maps on {resp.device}")


def select_keypoints(resp: torch.Tensor, headers: torch.Tensor, *, k: int,
                     threshold: float, halo: int):
    """Per-tile keypoint selection of response maps ``resp`` [N, H, W]
    fp32 with their headers [N, 6] int32: (count [N] int32, ys [N, K]
    int32, xs [N, K] int32, scores [N, K] fp32, valid [N, K] bool), K =
    min(k, H W), tile-local coordinates.  ``count`` is the owned pixels
    above ``threshold`` on the dense map; the slots hold the owned 3x3-NMS
    survivors above it by score, then flat index, and then the smallest
    flat indices that are not candidates (score 0, not valid): bit for bit
    `core/nms.py::select_keypoints`."""
    check_image(resp, "select_keypoints")
    check_headers(headers, resp)
    if resp.device.type == "cpu":
        return nms.select_keypoints(resp, headers, k, threshold, halo)
    n, h, w = resp.shape
    kk = max(0, min(int(k), h * w))
    cap = scratch_per_tile(h, w, halo, threshold)
    dev = resp.device
    keys = torch.empty(n * cap, dtype=torch.int64, device=dev)
    counts = torch.empty((2, n), dtype=torch.int32, device=dev)
    ys = torch.empty((n, kk), dtype=torch.int32, device=dev)
    xs = torch.empty((n, kk), dtype=torch.int32, device=dev)
    scores = torch.empty((n, kk), dtype=torch.float32, device=dev)
    valid = torch.empty((n, kk), dtype=torch.bool, device=dev)
    if n:
        KERNEL.launch(dev, resp.data_ptr(), headers.data_ptr(),
                      headers.shape[1], n, h, w, int(halo), float(threshold),
                      kk, cap, keys.data_ptr(), counts.data_ptr(),
                      ys.data_ptr(), xs.data_ptr(), scores.data_ptr(),
                      valid.data_ptr())
    return counts[0], ys, xs, scores, valid
