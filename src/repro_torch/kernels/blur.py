"""Separable Gaussian blur: wrapper of ``csrc/blur.cu``.

Replaces the Pallas ``repro/kernels/blur.py::blur_kernel``.  On a CUDA
tensor it launches the kernel; on a CPU tensor it runs the plain twin
``ref.gaussian_blur``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.pyramid import gaussian_kernel_1d
from repro_torch.kernels import ref
from repro_torch.kernels.build import MAX_RADIUS, CudaKernel, check_image

KERNEL = CudaKernel("blur", "difet_blur", [
    ctypes.c_void_p, ctypes.c_void_p,               # x, out
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int,  # n, h, w
    ctypes.c_void_p, ctypes.c_int,                  # taps (host), n_taps
])


def blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """x [N, H, W] fp32 -> blurred [N, H, W] (reflect pad r once)."""
    check_image(x, "blur")
    taps = np.ascontiguousarray(gaussian_kernel_1d(float(sigma)), np.float32)
    if (len(taps) - 1) // 2 > MAX_RADIUS:
        raise ValueError(f"blur: sigma {sigma} needs a radius above "
                         f"{MAX_RADIUS}")
    if x.device.type == "cpu":
        return ref.gaussian_blur(x, sigma)
    out = torch.empty_like(x)
    n, h, w = x.shape
    KERNEL.launch(x.device, x.data_ptr(), out.data_ptr(), n, h, w,
                  taps.ctypes.data, len(taps))
    return out
