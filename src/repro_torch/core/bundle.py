"""TileBundle — the HIB (HipiImageBundle) analogue: scenes cut into fixed
``tile × tile`` interior tiles with a ``halo`` overlap, plus a header table.

A numpy copy of ``repro/core/bundle.py``.  Each tile's header records its
scene id, grid position, valid interior extent (edge tiles are padded) and
a pad flag.  Feature ownership is interior-only: a corner found in a halo
belongs to the neighbouring tile, so global results are partition-invariant.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.configs.difet_paper import DifetConfig


@dataclasses.dataclass
class TileBundle:
    """A batch of tiles + header table (host-side metadata).

    tiles:   float32 [n_tiles, tile+2*halo, tile+2*halo]  (grayscale, 0..1)
    headers: int32   [n_tiles, 6] — (scene_id, ty, tx, valid_h, valid_w, pad)
    """
    tiles: np.ndarray
    headers: np.ndarray
    cfg: DifetConfig

    def __len__(self):
        return self.tiles.shape[0]

    @property
    def tile_hw(self) -> int:
        return self.cfg.tile + 2 * self.cfg.halo

    def pad_to(self, n: int) -> "TileBundle":
        """Pad with empty tiles (header pad flag = 1) up to ``n`` tiles."""
        cur = len(self)
        if cur >= n:
            return self
        extra = n - cur
        t = np.zeros((extra, self.tile_hw, self.tile_hw), np.float32)
        h = np.zeros((extra, 6), np.int32)
        h[:, 5] = 1
        return TileBundle(np.concatenate([self.tiles, t]),
                          np.concatenate([self.headers, h]), self.cfg)


def rgba_to_gray(img: np.ndarray) -> np.ndarray:
    """RGBA uint8 [H,W,4] -> grayscale float32 [H,W] in [0,1] (paper step 2)."""
    if img.ndim == 2:
        return img.astype(np.float32) / (255.0 if img.dtype == np.uint8 else 1.0)
    rgb = img[..., :3].astype(np.float32) / 255.0
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def tile_scene(gray: np.ndarray, cfg: DifetConfig,
               scene_id: int = 0) -> TileBundle:
    """Cut one grayscale scene into halo-padded fixed tiles."""
    t, halo = cfg.tile, cfg.halo
    h, w = gray.shape
    ny = (h + t - 1) // t
    nx = (w + t - 1) // t
    padded = np.pad(gray, ((halo, halo + ny * t - h), (halo, halo + nx * t - w)),
                    mode="reflect")
    tiles, headers = [], []
    for ty in range(ny):
        for tx in range(nx):
            y0, x0 = ty * t, tx * t
            tiles.append(padded[y0:y0 + t + 2 * halo, x0:x0 + t + 2 * halo])
            valid_h = min(t, h - y0)
            valid_w = min(t, w - x0)
            headers.append((scene_id, ty, tx, valid_h, valid_w, 0))
    return TileBundle(np.stack(tiles).astype(np.float32),
                      np.asarray(headers, np.int32), cfg)


def bundle_scenes(scenes: Sequence[np.ndarray], cfg: DifetConfig) -> TileBundle:
    bundles = [tile_scene(rgba_to_gray(s) if s.ndim == 3 else s, cfg, i)
               for i, s in enumerate(scenes)]
    return TileBundle(
        np.concatenate([b.tiles for b in bundles]),
        np.concatenate([b.headers for b in bundles]),
        cfg)


def _atomic_savez(path: Path, **arrays) -> None:
    """Crash-safe npz write: savez into a sibling ``<name>.tmp``, then
    atomically ``Path.replace`` it over the target, so a writer dying
    mid-write never leaves a truncated ``.npz``."""
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **arrays)
    tmp.replace(path)


class BundleStore:
    """Bundle storage (the HDFS stand-in): local npz files.  All writes are
    atomic (tmp + rename); ``list()``/``has_result`` only ever see
    fully-committed files."""

    def __init__(self, root):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def put(self, name: str, bundle: TileBundle) -> None:
        _atomic_savez(self.root / f"{name}.npz",
                      tiles=bundle.tiles, headers=bundle.headers,
                      cfg=json.dumps(dataclasses.asdict(bundle.cfg)))

    def get(self, name: str) -> TileBundle:
        z = np.load(self.root / f"{name}.npz", allow_pickle=False)
        cfg = DifetConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in json.loads(str(z["cfg"])).items()})
        return TileBundle(z["tiles"], z["headers"], cfg)

    def list(self) -> List[str]:
        return sorted(p.stem for p in self.root.glob("*.npz")
                      if not p.name.endswith(".result.npz"))

    def put_result(self, name: str, result: Dict[str, np.ndarray]) -> None:
        _atomic_savez(self.root / f"{name}.result.npz", **result)

    def has_result(self, name: str) -> bool:
        return (self.root / f"{name}.result.npz").exists()

    def get_result(self, name: str) -> Dict[str, np.ndarray]:
        z = np.load(self.root / f"{name}.result.npz")
        return {k: z[k] for k in z.files}
