"""The kernels' least times from their work counts, at the shapes of the
cells, against the bounds the port's kernel table was measured against;
the selection kernel's count at the cells' header layouts, and its device
name against the kernel names the cells showed before the kernel
existed."""
import numpy as np
import pytest

from portbench import profiling
from portbench.peaks import least_seconds


def _ms(kernel, shape, *args, **kwargs):
    return least_seconds(*profiling.work_modules()[kernel].work(
        shape, *args, **kwargs)) * 1e3


def scene_headers(ny, nx, tile, h, w):
    """``tile_scene``'s headers: row-major tiles, edge extents cut."""
    return np.array([(0, ty, tx, min(tile, h - ty * tile),
                      min(tile, w - tx * tile), 0)
                     for ty in range(ny) for tx in range(nx)], np.int32)


# the scene is 7681 x 7831: edge tiles own 1 row and 151 columns
PAPER_HEADERS = scene_headers(16, 16, 512, 7681, 7831)
SIFT_HEADERS = scene_headers(31, 31, 256, 7681, 7831)


@pytest.mark.parametrize("kernel,shape,args,kwargs,want,exact", [
    # one 256 x 560^2 map (the paper scene), bound by its bytes
    ("fastscore", (256, 560, 560), (), dict(threshold=0.15, arc=9), 0.1917,
     None),
    ("harris", (256, 560, 560), (), dict(k=0.04, sigma=1.0), 0.1917, None),
    ("harris", (256, 560, 560), (), dict(k=0.0, sigma=1.0,
                                         shi_tomasi=True), 0.1917, None),
    ("blur", (256, 560, 560), (1.6,), {}, 0.1917, None),
    # the octave on 961 tiles of 304^2 (tile 256), bound by its operations
    ("scalespace", (961, 304, 304), (),
     dict(scales_per_octave=3, contrast_threshold=0.04 / 3, sigma0=1.6),
     0.4515, None),
    # the selection at both cells' shapes, pinned: (pixels read, bytes
    # written), bound by its bytes
    ("select", (256, 560, 560), (PAPER_HEADERS,),
     dict(k=512, threshold=0.0, halo=24), 0.0735200179,
     (61_146_775, 1_704_960)),
    ("select", (961, 304, 304), (SIFT_HEADERS,),
     dict(k=256, threshold=0.0, halo=24), 0.0750916872,
     (62_088_775, 3_202_052)),
])
def test_least_time_at_the_cells_shapes(kernel, shape, args, kwargs, want,
                                        exact):
    if exact is None:
        assert _ms(kernel, shape, *args, **kwargs) == pytest.approx(
            want, abs=5e-5)
        return
    pixels, written = exact
    mod = profiling.work_modules()[kernel]
    assert mod.read_pixels(shape[1], shape[2], kwargs["halo"],
                           args[0])[1] == pixels
    ops, nbytes = mod.work(shape, *args, **kwargs)
    assert nbytes == 4 * pixels + written
    assert least_seconds(ops, nbytes) == pytest.approx(want * 1e-3,
                                                       rel=1e-9)
    assert ops / 67e12 < nbytes / 3.35e12          # bound by its bytes


def test_every_kernel_has_a_work_file_and_names():
    mods = profiling.work_modules()
    assert {"blur", "fastscore", "harris", "scalespace", "select"} <= set(
        mods)
    for mod in mods.values():
        assert mod.WRAPPER and mod.DEVICE_NAMES and callable(mod.work)


def test_work_grows_with_the_batch_and_the_radius():
    work = profiling.work_modules()["blur"].work
    assert work((2, 560, 560), 1.6)[0] == 2 * work((1, 560, 560), 1.6)[0]
    assert work((1, 560, 560), 3.2)[0] > work((1, 560, 560), 1.6)[0]


def test_a_padding_tile_reads_nothing():
    mod = profiling.work_modules()["select"]
    hd = np.array([(0, 0, 0, 512, 512, 1), (0, 0, 1, 0, 512, 0)], np.int32)
    assert mod.read_pixels(560, 560, 24, hd) == (0, 0)
    assert mod.work((2, 560, 560), hd, k=512, threshold=0.0,
                    halo=24) == (0, 2 * (4 + 512 * 13))


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
