"""The paper's own workload config: DIFET feature extraction over LandSat-8.

A copy of ``repro/configs/difet_paper.py`` (the port imports nothing of the
JAX package).  Paper setup (Section 4): LandSat-8 scenes ~7000x7000 RGBA,
cut here into fixed tiles with a halo overlap.
"""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class DifetConfig:
    # scene/tiling geometry
    scene_hw: Tuple[int, int] = (7681, 7831)   # the paper's example scene
    tile: int = 512                             # interior tile size (pixels)
    halo: int = 24                              # overlap; >= max detector window
    # detector parameters (OpenCV-compatible defaults, as the paper uses)
    harris_k: float = 0.04
    harris_threshold: float = 0.01              # relative to max response
    shi_tomasi_threshold: float = 0.01
    fast_threshold: float = 0.15                # intensity delta (0..1 scale)
    fast_arc: int = 9                           # FAST-9
    surf_hessian_threshold: float = 400.0       # paper: "Set surf hessian threshold to 400"
    # scale space (SIFT)
    n_octaves: int = 4
    scales_per_octave: int = 3
    sift_contrast_threshold: float = 0.04
    sift_edge_threshold: float = 10.0
    # descriptor parameters
    brief_n_bits: int = 256
    brief_patch: int = 31
    orb_n_features: int = 500
    # capacity: max keypoints kept per tile (static shapes)
    max_keypoints_per_tile: int = 512
    # numerics
    dtype: str = "float32"


PAPER_CONFIG = DifetConfig()

# Algorithms evaluated in the paper's Tables 1 & 2, in paper order.
PAPER_ALGORITHMS = (
    "harris", "shi_tomasi", "sift", "surf", "fast", "brief", "orb",
)
