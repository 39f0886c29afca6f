"""Fused SIFT scale-space octave: wrapper of ``csrc/scalespace.cu``.

Replaces the Pallas ``repro/kernels/scalespace.py::scalespace_kernel``.  On
a CUDA tensor it launches the kernel; on a CPU tensor it runs the plain
twin ``ref.scalespace_octave``.  An octave beyond the kernel's limits
raises ``ValueError`` on both devices before anything runs.  The kernel
lays out its launch (strip width, shared memory) itself; ``geometry``
reports it.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.pyramid import f32
from repro_torch.kernels import ref
from repro_torch.kernels.build import MAX_RADIUS, CudaKernel, check_image, load

MAX_LEVELS = 8           # csrc/scalespace.cu MAX_LEVELS

KERNEL = CudaKernel("scalespace", "difet_scalespace", [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # base, resp, seed
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,      # n, h, w
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,     # taps, n_taps, levels
    ctypes.c_int, ctypes.c_float,                       # seed_index, thr
])


def octave_taps(scales_per_octave: int, sigma0: float):
    """The octave's per-level taps, refused with ``ValueError`` where the
    kernel cannot take them (more than 8 levels or a radius above 16).
    Every octave within these limits fits the kernel's shared memory."""
    taps_list = ref.scalespace_taps(scales_per_octave, sigma0)
    if len(taps_list) > MAX_LEVELS or any(
            (len(t) - 1) // 2 > MAX_RADIUS for t in taps_list):
        raise ValueError("scalespace_octave: too many levels or too wide a "
                         "blur for the kernel")
    return taps_list


def _n_taps(taps_list):
    return np.asarray([len(t) for t in taps_list], np.int32)


def scalespace_octave(x: torch.Tensor, *, scales_per_octave: int,
                      contrast_threshold: float, sigma0: float = 1.6):
    """x [N, H, W] fp32 (the octave's level 0) -> (resp, seed), each
    [N, H, W]; the base is reflect-padded once by P = sum(radii) + 1."""
    check_image(x, "scalespace_octave")
    taps_list = octave_taps(scales_per_octave, sigma0)
    if x.device.type == "cpu":
        return ref.scalespace_octave(
            x, scales_per_octave=scales_per_octave,
            contrast_threshold=contrast_threshold, sigma0=sigma0)
    taps = np.ascontiguousarray(np.concatenate(taps_list), np.float32)
    n_taps = _n_taps(taps_list)
    resp = torch.empty_like(x)
    seed = torch.empty_like(x)
    n, h, w = x.shape
    KERNEL.launch(x.device, x.data_ptr(), resp.data_ptr(), seed.data_ptr(),
                  n, h, w, taps.ctypes.data, n_taps.ctypes.data,
                  len(taps_list), scales_per_octave, f32(contrast_threshold))
    return resp, seed


def geometry(scales_per_octave: int, sigma0: float, w: int):
    """(strip width, shared-memory bytes a block, blocks an SM) of the
    kernel's launch for the octave on images ``w`` wide, as the card lays
    it out (builds the library; the current CUDA device)."""
    n_taps = _n_taps(octave_taps(scales_per_octave, sigma0))
    fn = load("scalespace").difet_scalespace_geometry
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_longlong),
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    wt, nbytes, per_sm = ctypes.c_int(0), ctypes.c_longlong(0), ctypes.c_int(0)
    rc = fn(n_taps.ctypes.data, len(n_taps), w, ctypes.byref(wt),
            ctypes.byref(nbytes), ctypes.byref(per_sm))
    if rc != 0:
        raise RuntimeError(f"difet_scalespace_geometry: CUDA error {rc}")
    return wt.value, nbytes.value, per_sm.value
