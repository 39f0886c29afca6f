"""Harris / Shi-Tomasi structure-tensor response: wrapper of ``csrc/harris.cu``.

Replaces the Pallas ``repro/kernels/harris.py::harris_kernel``.  On a CUDA
tensor it launches the kernel; on a CPU tensor it runs the plain twin
``ref.harris``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.pyramid import f32, gaussian_kernel_1d
from repro_torch.kernels import ref
from repro_torch.kernels.build import MAX_RADIUS, CudaKernel, check_image

KERNEL = CudaKernel("harris", "difet_harris", [
    ctypes.c_void_p, ctypes.c_void_p,               # x, out
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,  # n, h, w
    ctypes.c_void_p, ctypes.c_int,                  # taps (host), n_taps
    ctypes.c_float, ctypes.c_int,                   # k, shi_tomasi
])


def harris(x: torch.Tensor, *, k: float = 0.04, sigma: float = 1.0,
           shi_tomasi: bool = False) -> torch.Tensor:
    """x [N, H, W] fp32 -> response [N, H, W] (reflect pad r+1 once)."""
    check_image(x, "harris")
    taps = np.ascontiguousarray(gaussian_kernel_1d(float(sigma)), np.float32)
    if (len(taps) - 1) // 2 > MAX_RADIUS:
        raise ValueError(f"harris: sigma {sigma} needs a window radius above "
                         f"{MAX_RADIUS}")
    if x.device.type == "cpu":
        return ref.harris(x, k=k, sigma=sigma, shi_tomasi=shi_tomasi)
    out = torch.empty_like(x)
    n, h, w = x.shape
    KERNEL.launch(x.device, x.data_ptr(), out.data_ptr(), n, h, w,
                  taps.ctypes.data, len(taps), f32(k), int(shi_tomasi))
    return out
