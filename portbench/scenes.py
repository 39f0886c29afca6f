"""Synthetic LandSat-like scenes drawn on the device from a seed, and the
tiler that cuts them into halo tiles.

A scene has the structure of a LandSat-8 gray band at 30 m: smooth
low-frequency terrain, crisp-edged rectangular fields (one per 20,000
pixels, up to an eighth of the scene a side, each shifting the level by up
to 0.35), bright 3x3 point targets (a quarter as many as the fields), and
sensor noise of 0.01, clipped to [0, 1].  Everything is drawn with one
``torch.Generator`` on the scene's device in a few large calls: fields and
targets are added exactly through an integer difference image and two
cumulative sums.

A configuration whose ``input`` is ``band_files`` keeps its scenes on disk
as LandSat-8 ships them, one file a band: `band_scene` turns a drawn gray
scene into the B4, B3 and B2 bands (uint8), and `write_bands` stores them
in the program's layout, a ``scene.json`` beside one ``.npy`` a band, each
file synced to the disk.
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from any whole number: seeds past
    64 bits are folded, so every ``--seed`` is accepted."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


UNIT = 2.0 ** -24          # levels are whole multiples of this


def _rect_sum(h, w, y0, x0, y1, x1, level, device):
    """Sum over rectangles [y0, y1) x [x0, x1) of ``level`` each: corners
    scattered into a difference image, then two inclusive scans.  Levels
    are rounded to whole multiples of ``UNIT`` and summed as integers, so
    the sum is exact and independent of the order of the scatter's atomic
    adds: the same seed gives the same pixels."""
    diff = torch.zeros((h + 1) * (w + 1), dtype=torch.int64, device=device)
    v = torch.round(level.double() / UNIT).long()
    for ys, xs, sign in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1),
                         (y1, x1, 1)):
        diff.index_add_(0, ys * (w + 1) + xs, sign * v)
    return diff.view(h + 1, w + 1).cumsum(0).cumsum(1)[:h, :w].double() * UNIT


def synthetic_scene(h: int, w: int, gen: torch.Generator) -> torch.Tensor:
    """Gray float32 [h, w] in [0, 1] on the generator's device."""
    dev = gen.device

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def randint(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev)

    # terrain: a coarse random grid, nearest-upsampled, two 4-neighbour
    # smoothing passes (wrapping at the borders)
    ch, cw = max(h // 64, 2), max(w // 64, 2)
    coarse = rand(ch, cw)
    terrain = (coarse.repeat_interleave(h // ch + 1, 0)
               .repeat_interleave(w // cw + 1, 1)[:h, :w])
    for _ in range(2):
        terrain = 0.25 * (terrain.roll(1, 0) + terrain.roll(-1, 0)
                          + terrain.roll(1, 1) + terrain.roll(-1, 1))
    img = 0.5 * terrain
    # fields with crisp edges and corners
    n_fields = max(4, int(h * w / 20000))
    y0 = randint(0, max(h - 8, 1), n_fields)
    x0 = randint(0, max(w - 8, 1), n_fields)
    y1 = (y0 + randint(6, max(h // 8, 7), n_fields)).clamp(max=h)
    x1 = (x0 + randint(6, max(w // 8, 7), n_fields)).clamp(max=w)
    level = (rand(n_fields) * 0.7 - 0.35)
    # bright point targets
    n_pts = max(2, n_fields // 4)
    py = randint(2, max(h - 3, 3), n_pts) - 1
    px = randint(2, max(w - 3, 3), n_pts) - 1
    img = img + _rect_sum(h, w, torch.cat([y0, py]), torch.cat([x0, px]),
                          torch.cat([y1, py + 3]), torch.cat([x1, px + 3]),
                          torch.cat([level, torch.full((n_pts,), 0.5,
                                                       device=dev)]),
                          dev).float()
    img = img + 0.01 * torch.randn((h, w), generator=gen, device=dev)
    return img.clamp(0.0, 1.0).contiguous()


def _reflect(n: int, before: int, after: int, device) -> torch.Tensor:
    """numpy's ``pad(mode="reflect")`` as an index map (edge not repeated;
    a pad wider than the axis reflects again)."""
    if n == 1:
        return torch.zeros(before + n + after, dtype=torch.int64,
                           device=device)
    j = torch.arange(-before, n + after, device=device).abs() % (2 * (n - 1))
    return torch.where(j >= n, 2 * (n - 1) - j, j)


def tile_scene(gray: torch.Tensor, tile: int, halo: int, scene_id: int = 0):
    """Cut a gray scene [h, w] into halo tiles: (tiles [ny nx, T, T]
    float32, headers [ny nx, 6] int32), T = tile + 2 halo, in row-major
    tile order.  The scene is reflect-padded by the halo and out to whole
    tiles; a header is (scene, ty, tx, valid_h, valid_w, 0)."""
    h, w = gray.shape
    dev = gray.device
    ny, nx = -(-h // tile), -(-w // tile)
    span = tile + 2 * halo
    padded = (gray.index_select(0, _reflect(h, halo, halo + ny * tile - h,
                                            dev))
              .index_select(1, _reflect(w, halo, halo + nx * tile - w, dev)))
    tiles = (padded.unfold(0, span, tile).unfold(1, span, tile)
             .reshape(ny * nx, span, span).contiguous())
    ty = torch.arange(ny, device=dev).repeat_interleave(nx)
    tx = torch.arange(nx, device=dev).repeat(ny)
    headers = torch.stack([
        torch.full_like(ty, scene_id), ty, tx,
        (h - ty * tile).clamp(max=tile), (w - tx * tile).clamp(max=tile),
        torch.zeros_like(ty)], dim=1).to(torch.int32)
    return tiles, headers


BANDS = ("B4", "B3", "B2")      # red, green, blue: the visible bands


def band_scene(gray: torch.Tensor) -> torch.Tensor:
    """The visible bands uint8 [3, h, w] (B4, B3, B2) of a gray scene in
    [0, 1]: the gray level, 0.9 and 0.8 of it, scaled to 255 and cut to
    whole levels, on the scene's device."""
    return (torch.stack([gray, gray * 0.9, gray * 0.8]) * 255).to(
        torch.uint8)


def _synced(f) -> None:
    f.flush()
    os.fsync(f.fileno())


def write_bands(root, name: str, bands: np.ndarray) -> Path:
    """Store a scene's bands uint8 [3, h, w] (`BANDS` order) under
    ``root/name``: ``B4.npy``, ``B3.npy``, ``B2.npy`` and ``scene.json``
    (name, h, w and the band names sorted), each file and the directory
    synced, so that no writeback of them is left for later.  Returns the
    scene's directory."""
    d = Path(root) / name
    d.mkdir(parents=True, exist_ok=True)
    for b, arr in zip(BANDS, bands):
        with open(d / f"{b}.npy", "wb") as f:
            np.save(f, np.ascontiguousarray(arr), allow_pickle=False)
            _synced(f)
    _, h, w = bands.shape
    with open(d / "scene.json", "w") as f:
        f.write(json.dumps({"name": name, "h": int(h), "w": int(w),
                            "bands": sorted(BANDS)}, indent=1))
        _synced(f)
    fd = os.open(d, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    return d
