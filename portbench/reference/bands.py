"""The plain tiler of a scene kept on disk as band files: it reads the
``.npy`` bands of a scene directory (``scene.json`` and ``B4``, ``B3``,
``B2``, uint8) itself, composes gray, reflect-pads and cuts halo tiles,
in numpy and nothing else.

Gray is float32: each band's uint8 level over 255, weighted 0.299 (B4),
0.587 (B3) and 0.114 (B2), and summed in that order.  The scene is
reflect-padded (numpy's ``reflect``: the edge not repeated) by the halo and
out to whole tiles; tiles come in row-major order, each with the header
(scene, ty, tx, valid_h, valid_w, 0).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

WEIGHTS = (("B4", 0.299), ("B3", 0.587), ("B2", 0.114))


def read_gray(scene_dir) -> np.ndarray:
    """Gray float32 [h, w] of the scene in ``scene_dir``."""
    d = Path(scene_dir)
    meta = json.loads((d / "scene.json").read_text())
    gray = None
    for band, weight in WEIGHTS:
        level = np.load(d / f"{band}.npy", allow_pickle=False)
        if level.dtype != np.uint8 or level.shape != (meta["h"], meta["w"]):
            raise ValueError(f"{d / band}.npy: {level.dtype} "
                             f"{level.shape}, not uint8 of the scene's shape")
        term = weight * (level.astype(np.float32) / 255.0)
        gray = term if gray is None else gray + term
    return gray


def tile_gray(gray: np.ndarray, tile: int, halo: int, scene_id: int = 0):
    """(tiles float32 [ny nx, T, T], headers int32 [ny nx, 6]) of a gray
    scene, T = tile + 2 halo."""
    h, w = gray.shape
    ny, nx = -(-h // tile), -(-w // tile)
    padded = np.pad(gray, ((halo, halo + ny * tile - h),
                           (halo, halo + nx * tile - w)), mode="reflect")
    span = tile + 2 * halo
    tiles, headers = [], []
    for ty in range(ny):
        for tx in range(nx):
            y0, x0 = ty * tile, tx * tile
            tiles.append(padded[y0:y0 + span, x0:x0 + span])
            headers.append((scene_id, ty, tx, min(tile, h - y0),
                            min(tile, w - x0), 0))
    return (np.stack(tiles).astype(np.float32),
            np.asarray(headers, dtype=np.int32))


def tile_scene(scene_dir, tile: int, halo: int, scene_id: int = 0):
    """`tile_gray` of the scene in ``scene_dir``."""
    return tile_gray(read_gray(scene_dir), tile, halo, scene_id)
