"""FAST-N segment-test score: wrapper of ``csrc/fastscore.cu``.

Replaces the Pallas ``repro/kernels/fastscore.py::fast_kernel``.  On a CUDA
tensor it launches the kernel; on a CPU tensor it runs the plain twin
``ref.fast_score``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.pyramid import f32
from repro_torch.kernels import ref
from repro_torch.kernels.build import CudaKernel, check_image

KERNEL = CudaKernel("fastscore", "difet_fast", [
    ctypes.c_void_p, ctypes.c_void_p,               # x, out
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,  # n, h, w
    ctypes.c_float, ctypes.c_int,                   # threshold, arc
])


def fast_score(x: torch.Tensor, *, threshold: float = 0.15,
               arc: int = 9) -> torch.Tensor:
    """x [N, H, W] fp32 -> FAST score [N, H, W] (reflect pad 3 once)."""
    check_image(x, "fast_score")
    if not 1 <= arc <= 16:
        raise ValueError(f"fast_score: arc must be in 1..16, got {arc}")
    if x.device.type == "cpu":
        return ref.fast_score(x, threshold=threshold, arc=arc)
    out = torch.empty_like(x)
    n, h, w = x.shape
    KERNEL.launch(x.device, x.data_ptr(), out.data_ptr(), n, h, w,
                  f32(threshold), arc)
    return out
