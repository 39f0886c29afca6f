"""The fused SIFT octave, ``ops.scalespace_octave(base, scales_per_octave=,
contrast_threshold=, sigma0=)``: the operations the octave's levels need.

From the base (blurred to sigma0), level s is the blur of level s - 1 by
the increment to sigma0 2^(s/spo), for s = 1 .. spo + 2; with the base
padded once by m = sum of the radii + 1, level s is needed over a margin
shrinking by its radius.  Per level: its W and H passes over that margin,
the DoG over the interior plus a ring of 1; then the extrema at their
least (a separable 3x3 max and min per DoG level, the 8-ring's extra max
and min per mid level, and per mid level the combination, two compares, an
or, the absolute value, the threshold, a select and the running max).
Bytes: the base read once, the response and the next octave's seed level
written once (fp32)."""
import math

from portbench.work._taps import images, pass_ops, radius

WRAPPER = "scalespace_octave"
DEVICE_NAMES = ("scalespace_strip",)


def increments(spo: int, sigma0: float):
    k = 2.0 ** (1.0 / spo)
    incs, prev = [], sigma0
    for s in range(1, spo + 3):
        total = sigma0 * k ** s
        incs.append(math.sqrt(max(total ** 2 - prev ** 2, 1e-6)))
        prev = total
    return incs


def work(shape, scales_per_octave=3, contrast_threshold=0.0, sigma0=1.6):
    n, h, w = images(shape)
    radii = [radius(s) for s in increments(scales_per_octave, sigma0)]
    m = sum(radii) + 1
    ops = 0
    for r in radii:
        mc = m - r
        ops += (h + 2 * m) * (w + 2 * mc) * pass_ops(r)     # W pass
        ops += (h + 2 * mc) * (w + 2 * mc) * pass_ops(r)    # H pass
        ops += (h + 2) * (w + 2)                            # DoG
        m = mc
    levels, mids = len(radii), len(radii) - 2
    ops += levels * ((h + 2) * w * 4 + h * w * 4) + mids * h * w * 2
    ops += h * w * (12 * mids - 1)
    return n * ops, n * h * w * 12
