"""Synthetic LandSat-8-like scenes and band-striped scene readers (numpy).

Copies of ``repro/data/landsat.py``: the same numpy arithmetic from the same
seed, so both packages see the same pixels.  Smooth terrain + field edges +
point targets + speckle noise, enough structure for every detector to fire.

LandSat-8 is distributed as one GeoTIFF per band, and the streaming ingest
(`data/pipeline.py`) mirrors that: a scene on disk is a directory of
per-band ``.npy`` files plus a ``scene.json`` (`write_scene_bands`, whose
files are byte-identical to the reference's), which `BandSceneReader`
memory-maps and reads stripe by stripe, composing grayscale in the same
expression order as `core/bundle.py::rgba_to_gray`, so the streamed pixels
are bit-identical to the eager path's.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from repro_torch.core.bundle import rgba_to_gray

# grayscale composition weights per band name: rgba_to_gray's Rec.601
# weights, keyed by the LandSat-8 visible band ids (B4 red, B3 green, B2
# blue).  "gray" means the scene is already single-band.
GRAY_WEIGHTS = {"B4": 0.299, "B3": 0.587, "B2": 0.114}


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


# ---------------------------------------------------------------------------
# band-striped scene storage + streaming readers
# ---------------------------------------------------------------------------

class SceneReader:
    """Row-stripe access to one grayscale scene.

    The streaming ingest contract (`data/pipeline.py`): a reader exposes
    ``shape`` up front and serves ``read_rows(y0, y1)``, a float32
    grayscale stripe ``[y1 - y0, w]`` in ``[0, 1]``, without ever
    materializing the full scene.  Its pixels are bit-identical to the
    eager path's (`rgba_to_gray` over the whole image).
    """

    name: str
    shape: Tuple[int, int]

    def read_rows(self, y0: int, y1: int) -> np.ndarray:
        """Return grayscale rows ``[y0, y1)`` as float32 ``[y1-y0, w]``."""
        raise NotImplementedError

    def stripes(self, stripe_rows: int):
        """Yield ``read_rows`` stripes of ``stripe_rows`` rows (the last one
        ragged).  ``stripe_rows`` must be positive."""
        if stripe_rows <= 0:
            raise ValueError(f"stripe_rows must be positive, "
                             f"got {stripe_rows}")
        h = self.shape[0]
        for y0 in range(0, h, stripe_rows):
            yield self.read_rows(y0, min(y0 + stripe_rows, h))


class ArraySceneReader(SceneReader):
    """In-memory reader over a grayscale or RGBA array (tests, smoke runs).

    Accepts float32 grayscale ``[H, W]``, uint8 grayscale, or RGBA uint8
    ``[H, W, 4]``; each stripe is converted by `rgba_to_gray`, so streamed
    pixels match the eager path bit for bit.
    """

    def __init__(self, image: np.ndarray, name: str = "scene"):
        self._img = np.asarray(image)
        if self._img.ndim not in (2, 3):
            raise ValueError(f"scene must be [H,W] or [H,W,C], "
                             f"got shape {self._img.shape}")
        self.name = name
        self.shape = tuple(self._img.shape[:2])

    def read_rows(self, y0: int, y1: int) -> np.ndarray:
        """Grayscale rows ``[y0, y1)``: the eager converter on this slice."""
        return rgba_to_gray(self._img[y0:y1])


class BandSceneReader(SceneReader):
    """Memory-mapped reader over a band-striped scene on disk.

    A scene directory (written by `write_scene_bands`) holds one ``.npy``
    per band and a ``scene.json`` manifest.  ``read_rows`` touches only the
    requested row slab of each band's memmap and composes grayscale with
    `GRAY_WEIGHTS` in `rgba_to_gray`'s order: one stripe of host memory per
    call, never the whole scene.

    Raises ``IOError`` for truncated or corrupt band files and
    ``ValueError`` when the manifest's bands are missing, extra, or of
    another shape.
    """

    def __init__(self, root):
        self.root = Path(root)
        meta_path = self.root / "scene.json"
        if not meta_path.exists():
            raise FileNotFoundError(f"no scene.json under {self.root}")
        meta = json.loads(meta_path.read_text())
        self.name = meta["name"]
        self.shape = (int(meta["h"]), int(meta["w"]))
        bands = tuple(meta["bands"])
        if bands != ("gray",) and set(bands) != set(GRAY_WEIGHTS):
            raise ValueError(
                f"scene {self.name!r}: band set {bands} is neither "
                f"('gray',) nor {tuple(sorted(GRAY_WEIGHTS))}")
        self._bands: Dict[str, np.ndarray] = {}
        for b in bands:
            path = self.root / f"{b}.npy"
            try:
                arr = np.load(path, mmap_mode="r", allow_pickle=False)
            except Exception as e:  # noqa: BLE001 (truncation surfaces here)
                raise IOError(
                    f"scene {self.name!r}: band file {path} unreadable "
                    f"(truncated or corrupt): {e}") from e
            if arr.shape != self.shape:
                raise ValueError(
                    f"scene {self.name!r}: band {b!r} shape {arr.shape} "
                    f"!= manifest shape {self.shape}")
            self._bands[b] = arr

    def read_rows(self, y0: int, y1: int) -> np.ndarray:
        """Grayscale rows ``[y0, y1)`` as float32 ``[y1-y0, w]``, reading
        only that row slab of each band."""
        if "gray" in self._bands:
            g = self._bands["gray"][y0:y1]
            if g.dtype == np.uint8:
                return np.asarray(g, np.float32) / 255.0
            return np.asarray(g, np.float32)
        # rgba_to_gray's weights in its expression order: bitwise its floats
        r = np.asarray(self._bands["B4"][y0:y1], np.float32) / 255.0
        g = np.asarray(self._bands["B3"][y0:y1], np.float32) / 255.0
        b = np.asarray(self._bands["B2"][y0:y1], np.float32) / 255.0
        return (GRAY_WEIGHTS["B4"] * r + GRAY_WEIGHTS["B3"] * g
                + GRAY_WEIGHTS["B2"] * b)


def write_scene_bands(root, name: str, image: np.ndarray) -> Path:
    """Store a scene band-striped: one ``.npy`` per band + ``scene.json``.

    RGBA uint8 input splits into the B4/B3/B2 visible-band files (alpha is
    constant in the paper's inputs and grayscale never reads it); grayscale
    input is stored as one ``gray`` band.  Returns the scene directory,
    readable by `BandSceneReader`.
    """
    image = np.asarray(image)
    d = Path(root) / name
    d.mkdir(parents=True, exist_ok=True)
    if image.ndim == 3:
        bands = {"B4": image[..., 0], "B3": image[..., 1],
                 "B2": image[..., 2]}
    elif image.ndim == 2:
        bands = {"gray": image}
    else:
        raise ValueError(f"scene must be [H,W] or [H,W,4], "
                         f"got shape {image.shape}")
    for b, arr in bands.items():
        np.save(d / f"{b}.npy", np.ascontiguousarray(arr),
                allow_pickle=False)
    (d / "scene.json").write_text(json.dumps(
        {"name": name, "h": int(image.shape[0]), "w": int(image.shape[1]),
         "bands": sorted(bands)}, indent=1))
    return d


def write_synthetic_scene_set(root, n_scenes: int, h: int, w: int,
                              seed0: int = 0) -> list:
    """Write the paper's fixed scene set (N synthetic RGBA scenes)
    band-striped under ``root``; returns the scene directories in name
    order, the manifest order every worker count must agree on."""
    return [write_scene_bands(root, f"scene_{seed0 + i:04d}",
                              synthetic_scene_rgba(h, w, seed=seed0 + i))
            for i in range(n_scenes)]
