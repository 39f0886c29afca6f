"""The kernels' least times from their work counts, at the shapes of the
cells, against the bounds the port's kernel table was measured against."""
import pytest

from portbench import profiling
from portbench.peaks import least_seconds


def _ms(kernel, shape, *args, **kwargs):
    return least_seconds(*profiling.work_modules()[kernel].work(
        shape, *args, **kwargs)) * 1e3


@pytest.mark.parametrize("kernel,shape,args,kwargs,want", [
    # one 256 x 560^2 map (the paper scene), bound by its bytes
    ("fastscore", (256, 560, 560), (), dict(threshold=0.15, arc=9), 0.1917),
    ("harris", (256, 560, 560), (), dict(k=0.04, sigma=1.0), 0.1917),
    ("harris", (256, 560, 560), (), dict(k=0.0, sigma=1.0,
                                         shi_tomasi=True), 0.1917),
    ("blur", (256, 560, 560), (1.6,), {}, 0.1917),
    # the octave on 961 tiles of 304^2 (tile 256), bound by its operations
    ("scalespace", (961, 304, 304), (),
     dict(scales_per_octave=3, contrast_threshold=0.04 / 3, sigma0=1.6),
     0.4515),
])
def test_least_time_at_the_cells_shapes(kernel, shape, args, kwargs, want):
    assert _ms(kernel, shape, *args, **kwargs) == pytest.approx(want,
                                                                abs=5e-5)


def test_every_kernel_has_a_work_file_and_names():
    mods = profiling.work_modules()
    assert {"blur", "fastscore", "harris", "scalespace"} <= set(mods)
    for mod in mods.values():
        assert mod.WRAPPER and mod.DEVICE_NAMES and callable(mod.work)


def test_work_grows_with_the_batch_and_the_radius():
    work = profiling.work_modules()["blur"].work
    assert work((2, 560, 560), 1.6)[0] == 2 * work((1, 560, 560), 1.6)[0]
    assert work((1, 560, 560), 3.2)[0] > work((1, 560, 560), 1.6)[0]
