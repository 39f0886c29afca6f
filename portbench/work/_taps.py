"""Shared arithmetic of the separable Gaussian passes."""
import math


def radius(sigma: float) -> int:
    """Radius of a Gaussian window cut at 3 sigma (at least 1)."""
    return max(1, int(math.ceil(3.0 * float(sigma))))


def pass_ops(r: int) -> int:
    """One symmetric 1-D pass of 2r + 1 taps at its least: r pair adds,
    r + 1 multiplies and r adds."""
    return 3 * r + 1


def images(shape) -> tuple:
    """(n, h, w) of an image batch [..., H, W]."""
    n = 1
    for d in shape[:-2]:
        n *= d
    return n, shape[-2], shape[-1]
