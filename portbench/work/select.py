"""Keypoint selection, ``ops.select_keypoints(resp, headers, k=,
threshold=, halo=)``: each tile's owned pixels and the two-pixel ring
around them (what strict 3x3 NMS with its tie-break reads), clipped to the
tile, read once as fp32; a padding tile reads nothing.  Written once: the
count (int32) and the K slots (int32 y, int32 x, fp32 score, bool valid)
of every tile.  Operations: the 3x3 window's 8 compares and the
threshold's two per owned pixel; the bytes bound it.  The owned extents are
the recorded headers' (valid_h, valid_w at columns 3 and 4, the padding
flag at 5), read after the window."""
import numpy as np

WRAPPER = "select_keypoints"
DEVICE_NAMES = ("difet_select",)
SLOT_BYTES = 4 + 4 + 4 + 1
RING = 2


def read_pixels(h, w, halo, headers):
    """(owned pixels, pixels read) summed over the tiles."""
    hd = np.asarray(headers.cpu() if hasattr(headers, "cpu") else headers,
                    dtype=np.int64)
    live = hd[:, 5] == 0
    o0 = max(halo, 0)
    y1 = np.minimum(h, halo + hd[:, 3])
    x1 = np.minimum(w, halo + hd[:, 4])
    oh = np.clip(y1 - o0, 0, None) * live
    ow = np.clip(x1 - o0, 0, None) * live
    some = (oh > 0) & (ow > 0)
    rh = (np.minimum(h, y1 + RING) - max(o0 - RING, 0)) * some
    rw = (np.minimum(w, x1 + RING) - max(o0 - RING, 0)) * some
    return int((oh * ow).sum()), int((rh * rw).sum())


def work(shape, headers, k, threshold, halo):
    n, h, w = shape
    owned, read = read_pixels(h, w, halo, headers)
    slots = min(k, h * w)
    return owned * 10, read * 4 + n * (4 + slots * SLOT_BYTES)
