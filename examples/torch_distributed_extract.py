"""Distributed extraction with fault tolerance on the PyTorch port: build a
bundle store, run a checkpointed DIFET job, kill it mid-flight, and
restart; the restarted job resumes from the manifest.  The steps of
``examples/distributed_extract.py``, on the CUDA card by default or on the
CPU with ``--device cpu``.

    PYTHONPATH=src python examples/torch_distributed_extract.py
        [--device cpu] [--size N]
"""
import argparse
import shutil
import tempfile
from pathlib import Path

from repro_torch.configs.difet_paper import DifetConfig
from repro_torch.core import BundleStore, bundle_scenes
from repro_torch.core.job import DifetJob
from repro_torch.data.landsat import synthetic_scene

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device (default: the CUDA card)")
ap.add_argument("--size", type=int, default=300,
                help="each of the 4 scenes is size x size")
args = ap.parse_args()

root = Path(tempfile.mkdtemp(prefix="difet_torch_"))
cfg = DifetConfig(tile=128, halo=24, max_keypoints_per_tile=64)
store = BundleStore(root)
for i in range(4):
    store.put(f"bundle_{i}", bundle_scenes(
        [synthetic_scene(args.size, args.size, seed=i)], cfg))
print(f"store: {store.list()}")

# --- first attempt: dies after 2 bundles (simulated node failure) ----------
job = DifetJob(store, "harris", shards_per_bundle=2, device=args.device)
try:
    job.run(simulate_failure_after=2,
            progress=lambda n: print(f"  [worker] finished {n}"))
except RuntimeError as e:
    print(f"!! {e}")

# --- restart: only the remaining bundles run -------------------------------
print("restarting job ...")
job2 = DifetJob(store, "harris", shards_per_bundle=2, device=args.device)
print(f"  remaining after restart: {job2.manifest.remaining}")
summary = job2.run(progress=lambda n: print(f"  [worker] finished {n}"))
print(f"done: {summary['bundles_done']}/{summary['bundles_total']} bundles, "
      f"{summary['grand_total']} features total")

# --- elastic scaling: rebalance outstanding work over a new worker set -----
job3 = DifetJob(store, "sift", shards_per_bundle=2, device=args.device)
for n_workers in (2, 3):
    parts = job3.rebalance(n_workers)
    print(f"elastic rebalance over {n_workers} workers: "
          f"{[len(p) for p in parts]} bundles each")
shutil.rmtree(root)
