"""Separable Gaussian blur, ``ops.gaussian_blur(img, sigma)``: the W pass
over the rows the H pass needs, then the H pass; each input pixel read
once, each output written once (fp32)."""
from portbench.work._taps import images, pass_ops, radius

WRAPPER = "gaussian_blur"
DEVICE_NAMES = ("blur_tiled", "blur_small")


def work(shape, sigma):
    n, h, w = images(shape)
    r = radius(sigma)
    return n * ((h + 2 * r) * w + h * w) * pass_ops(r), n * h * w * 8
