"""The selection kernel's work count (``portbench/work/select.py``) at the
cells' shapes and header layouts, and its device name against the kernel
names the cells showed before the kernel existed."""
import numpy as np
import pytest

from portbench import profiling
from portbench.peaks import least_seconds

# the device kernels the profiler named in the cells' traced windows
# before the selection kernel (the top ten of each cell)
TORCH_KERNELS = (
    "void_at_cuda_detail::cub::DeviceSegmentedRadixSortKernel_at_cuda",
    "void_at::native::elementwise_kernel_128__2__at::native::gpu_kern",
    "void_at::native::_scatter_gather_elementwise_kernel_128__8__at::",
    "void_at::native::_anonymous_namespace_::max_pool_forward_nchw_fl",
    "void_at::native::vectorized_elementwise_kernel_4__at::native::CU",
    "void_at::native::unrolled_elementwise_kernel_at::native::direct_",
    "void_at::native::vectorized_elementwise_kernel_4__at::native::_a",
    "void_at::native::elementwise_kernel_128__4__at::native::gpu_kern",
    "_anonymous_namespace_::scalespace_strip_float_const___float___fl",
    "void_at::native::reduce_kernel_128__4__at::native::ReduceOp_floa",
)


def scene_headers(ny, nx, tile, h, w):
    """``tile_scene``'s headers: row-major tiles, edge extents cut."""
    return np.array([(0, ty, tx, min(tile, h - ty * tile),
                      min(tile, w - tx * tile), 0)
                     for ty in range(ny) for tx in range(nx)], np.int32)


# the scene is 7681 x 7831: edge tiles own 1 row and 151 columns
CELLS = {
    "paper-t512.all7": ((256, 560, 560), scene_headers(16, 16, 512, 7681,
                                                       7831), 512,
                        61_146_775, 1_704_960, 0.0735200179),
    "sift-t256.sift": ((961, 304, 304), scene_headers(31, 31, 256, 7681,
                                                      7831), 256,
                       62_088_775, 3_202_052, 0.0750916872),
}


@pytest.mark.parametrize("cell", list(CELLS))
def test_least_time_at_the_cells_shapes(cell):
    shape, headers, k, pixels, written, ms = CELLS[cell]
    mod = profiling.work_modules()["select"]
    assert mod.read_pixels(shape[1], shape[2], 24, headers)[1] == pixels
    ops, nbytes = mod.work(shape, headers, k=k, threshold=0.0, halo=24)
    assert nbytes == 4 * pixels + written
    assert least_seconds(ops, nbytes) == pytest.approx(ms * 1e-3, rel=1e-9)
    assert ops / 67e12 < nbytes / 3.35e12          # bound by its bytes


def test_a_padding_tile_reads_nothing():
    mod = profiling.work_modules()["select"]
    hd = np.array([(0, 0, 0, 512, 512, 1), (0, 0, 1, 0, 512, 0)], np.int32)
    assert mod.read_pixels(560, 560, 24, hd) == (0, 0)
    assert mod.work((2, 560, 560), hd, k=512, threshold=0.0,
                    halo=24) == (0, 2 * (4 + 512 * 13))


def test_device_name_is_the_kernels_own():
    mods = profiling.work_modules()
    names = mods["select"].DEVICE_NAMES
    kernels = ("_anonymous_namespace_::difet_select_scan_float_const_",
               "_anonymous_namespace_::difet_select_topk_unsigned_long")
    for p in names:
        assert not any(p in n for n in TORCH_KERNELS)
        assert all(p in n for n in kernels)
    for name, mod in mods.items():
        if name != "select":
            assert not any(p in n for p in mod.DEVICE_NAMES for n in kernels)
