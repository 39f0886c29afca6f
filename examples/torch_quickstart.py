"""Quickstart on the PyTorch port: extract features from a synthetic
LandSat-like scene with every algorithm the paper implements (Harris,
Shi-Tomasi, SIFT, SURF, FAST, BRIEF, ORB) through ``repro_torch``: on the
CUDA card with its kernels by default, or on the CPU (the kernels' plain
twins) with ``--device cpu``.  The steps of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
        [--size H W] [--tile T]
"""
import argparse

from repro_torch.configs.difet_paper import DifetConfig, PAPER_ALGORITHMS
from repro_torch.core import bundle_scenes, extract_features
from repro_torch.data.landsat import synthetic_scene_rgba

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
ap.add_argument("--size", type=int, nargs=2, default=(600, 800),
                metavar=("H", "W"))
ap.add_argument("--tile", type=int, default=256)
args = ap.parse_args()
h, w = args.size

# 1. a scene in the paper's format (RGBA, 32-bit pixels)
scene = synthetic_scene_rgba(h, w, seed=0)

# 2. tile it into a shardable bundle (the HipiImageBundle analogue)
cfg = DifetConfig(tile=args.tile, halo=24, max_keypoints_per_tile=128)
bundle = bundle_scenes([scene], cfg)
print(f"scene {h}x{w} -> {len(bundle)} tiles of "
      f"{bundle.tile_hw}x{bundle.tile_hw} (halo={cfg.halo})")

# 3. run each detector/descriptor (the paper's map function) and the reduce
for alg in PAPER_ALGORITHMS:
    r = extract_features(bundle.tiles, bundle.headers, alg, cfg,
                         device=args.device)
    desc = r.get("top_desc")
    dshape = "-" if desc is None else f"{desc.shape[1]}-d"
    print(f"  {alg:11s} features={int(r['total_count']):6d} "
          f"keypoints={int(r['keypoint_count']):5d} desc={dshape}")

# 4. strongest keypoint in scene coordinates
r = extract_features(bundle.tiles, bundle.headers, "harris", cfg,
                     device=args.device)
y, x = int(r["top_ys"][0]), int(r["top_xs"][0])
print(f"strongest Harris corner at (y={y}, x={x}) "
      f"score={float(r['top_scores'][0]):.4f}")
