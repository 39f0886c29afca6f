"""Harris / Shi-Tomasi response, ``ops.harris(img, k=, sigma=,
shi_tomasi=)``: Sobel gradients and their three products over the
window's support, the three separable Gaussian sums, and the response
(Harris: det - k tr^2, 7 operations; Shi-Tomasi: the smaller eigenvalue,
10); each input pixel read once, each output written once (fp32)."""
from portbench.work._taps import images, pass_ops, radius

WRAPPER = "harris"
DEVICE_NAMES = ("harris_kernel",)


def work(shape, k=0.04, sigma=1.0, shi_tomasi=False):
    n, h, w = images(shape)
    r = radius(sigma)
    grad = (h + 2 * r) * (w + 2 * r) * (2 * 8 + 3)   # 2 Sobel + 3 products
    wpass = 3 * (h + 2 * r) * w * pass_ops(r)
    hpass = 3 * h * w * pass_ops(r)
    resp = h * w * (10 if shi_tomasi else 7)
    return n * (grad + wpass + hpass + resp), n * h * w * 8
