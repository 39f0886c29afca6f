"""FAST segment-test score, ``ops.fast_score(img, threshold=, arc=)``.

Operations: the compass pre-test that any exact FAST needs on every pixel
(centre + t and centre - t, 8 compares, 8 to pack the two 4-bit flag sets,
4 to look them up); the full ring test on the pixels that pass it depends
on the data and is not counted, so the count is a lower one.  Bytes: each
input pixel read once, each output written once (fp32)."""
from portbench.work._taps import images

WRAPPER = "fast_score"
DEVICE_NAMES = ("fast_tiled",)


def work(shape, threshold=0.15, arc=9):
    n, h, w = images(shape)
    return n * h * w * (2 + 8 + 8 + 4), n * h * w * 8
