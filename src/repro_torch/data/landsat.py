"""Synthetic LandSat-8-like scenes (numpy).

Copies of ``repro/data/landsat.py::synthetic_scene`` and
``synthetic_scene_rgba``: the same numpy arithmetic from the same seed, so
both packages see the same pixels.  Smooth terrain + field edges + point
targets + speckle noise, enough structure for every detector to fire.
"""
from __future__ import annotations

import numpy as np


def synthetic_scene(h: int, w: int, seed: int = 0,
                    density: float = 1.0) -> np.ndarray:
    """Grayscale float32 [h, w] in [0, 1].  ``density`` scales the count of
    fields/blobs (1.0 = the default)."""
    rng = np.random.RandomState(seed)
    # smooth low-frequency terrain
    coarse = rng.rand(max(h // 64, 2), max(w // 64, 2)).astype(np.float32)
    reps = (h // coarse.shape[0] + 1, w // coarse.shape[1] + 1)
    terrain = np.kron(coarse, np.ones(reps, np.float32))[:h, :w]
    for _ in range(2):   # cheap smoothing passes
        terrain = 0.25 * (np.roll(terrain, 1, 0) + np.roll(terrain, -1, 0)
                          + np.roll(terrain, 1, 1) + np.roll(terrain, -1, 1))
    img = 0.5 * terrain
    # rectangular "fields" with crisp edges/corners
    n_fields = max(4, int(density * (h * w) / 20000))
    for _ in range(n_fields):
        y0 = rng.randint(0, max(h - 8, 1))
        x0 = rng.randint(0, max(w - 8, 1))
        fh = rng.randint(6, max(h // 8, 7))
        fw = rng.randint(6, max(w // 8, 7))
        img[y0:y0 + fh, x0:x0 + fw] += rng.uniform(-0.35, 0.35)
    # bright point targets (blobs)
    for _ in range(max(2, n_fields // 4)):
        y = rng.randint(2, max(h - 3, 3))
        x = rng.randint(2, max(w - 3, 3))
        img[y - 1:y + 2, x - 1:x + 2] += 0.5
    img += 0.01 * rng.randn(h, w).astype(np.float32)   # sensor noise
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def synthetic_scene_rgba(h: int, w: int, seed: int = 0) -> np.ndarray:
    """RGBA uint8 [h, w, 4] — the paper's input format (32-bit pixels)."""
    g = synthetic_scene(h, w, seed)
    rgba = np.stack([g, g * 0.9, g * 0.8, np.ones_like(g)], axis=-1)
    return (rgba * 255).astype(np.uint8)
