"""Scene-pair registration and mosaic layout: the stitching workload built
on DIFET extraction results.

Port of ``repro/core/mosaic.py``.  The pipeline (driven by
``launch/stitch.py``):

  1. per-scene extraction results (top-K keypoints and descriptors with
     validity masks) are loaded from the ``BundleStore``;
  2. the pair list is cut into chunks and registered by ``MatchPhase``, a
     checkpointed ``ManifestJob``; each chunk goes through
     ``make_pair_solver``, which registers its pairs one after the other
     on the device (the reference's ``vmap`` over pairs, written as a
     loop, so each pair's result equals the single-pair call); with
     ``mesh=`` the chunk's pairs are split over the mesh's devices
     (`_shard_batch`), each entry registering its own pairs on its card;
  3. ``solve_layout`` anchors the first scene and walks the inlier-verified
     pair graph to absolute positions; ``mosaic_summary`` reports them.

Pair results are stored under a job-qualified name, so a killed match
phase resumes where it died.  RANSAC draws come from (seed, pair index)
(``matching.uniform_draws``), so neither a restart nor a mesh changes a
pair's registration.
"""
from __future__ import annotations

import functools
import hashlib
import json
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import matching
from repro_torch.core.bundle import BundleStore
from repro_torch.core.engine import resolve_device
from repro_torch.core.job import ManifestJob
from repro_torch.distributed.sharding import (MeshRunner, one_device,
                                              split_rows)


def pair_name(a: str, b: str) -> str:
    return f"{a}__{b}"


def load_scene_features(store: BundleStore, scene: str,
                        algorithm: str) -> Dict[str, np.ndarray]:
    """Top-K features of one scene from its extraction result (global
    scene coordinates, descriptors, validity)."""
    r = store.get_result(f"{scene}.{algorithm}")
    if "top_desc" not in r:
        raise ValueError(
            f"algorithm {algorithm!r} stores no descriptors; the match "
            "phase needs one of sift/surf/brief/orb")
    return {"ys": r["top_ys"], "xs": r["top_xs"],
            "desc": r["top_desc"], "valid": r["top_valid"]}


def make_pair_solver(metric: Optional[str], ratio: float, tol: float,
                     iters: int, use_kernels: Optional[bool] = None,
                     device=None):
    """Batched registration: every argument has a leading pair axis P; the
    solver registers pair after pair on ``device`` and returns stacked
    ``t``, ``n_inliers``, ``n_matches`` and ``rms`` as tensors.  ``draws``
    [P, iters] are each pair's RANSAC numbers."""
    dev = resolve_device(device)

    def solve(ya, xa, da, va, yb, xb, db, vb, draws):
        outs = []
        for p in range(len(ya)):
            a = [torch.as_tensor(x[p]).to(dev) for x in (ya, xa, da, va)]
            b = [torch.as_tensor(x[p]).to(dev) for x in (yb, xb, db, vb)]
            m, est = matching.register_pair(
                *a, *b, torch.as_tensor(draws[p]).to(dev), ratio, tol,
                metric=metric, model="translation", iters=iters,
                use_kernels=use_kernels)
            outs.append({"t": est.t, "n_inliers": est.n_inliers,
                         "n_matches": m.ok.sum().to(torch.int32),
                         "rms": est.rms})
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    return solve


def _shard_batch(arrays: List, mesh) -> List[Tuple[int, List]]:
    """The leading pair axis split over the mesh: ``(entry, [each array's
    rows of that entry])`` for each entry given pairs, contiguous and in
    mesh order (`split_rows`; uneven where P is not a multiple of the mesh
    size, so the reference's padding of P has no counterpart)."""
    return [(i, [a[lo:hi] for a in arrays])
            for i, (lo, hi) in enumerate(split_rows(len(arrays[0]), mesh))
            if hi > lo]


class MatchPhase(ManifestJob):
    """Checkpointed pairwise registration over extraction results.

    Work items are fixed chunks of the pair list; each pair commits its own
    ``<a>__<b>.match`` result.  Restart-deterministic: the RANSAC draws come
    from the seed and the global pair index, not from the clock.  With
    ``mesh`` (a `distributed/sharding.py::Mesh`, instead of ``device``)
    each chunk's pairs are split over the mesh's devices, each entry
    registering its own on its card and stream; a pair's result does not
    depend on the entry that registered it.  A mesh of one entry registers
    on its device, as ``device`` does."""

    def __init__(self, store: BundleStore, pairs: Sequence[Tuple[str, str]],
                 algorithm: str, *, metric: Optional[str] = None,
                 ratio: float = 0.8, tol: float = 2.0, iters: int = 128,
                 pairs_per_step: int = 8, use_kernels: Optional[bool] = None,
                 device=None, manifest_path=None, seed: int = 0, mesh=None):
        mesh, device = one_device(mesh, device)
        self.pairs = [tuple(p) for p in pairs]
        self._pair_index = {p: i for i, p in enumerate(self.pairs)}
        self.algorithm = algorithm
        self.seed = seed
        self.device = device
        self.mesh = mesh
        self._params = (metric, float(ratio), float(tol), int(iters),
                        use_kernels)
        self._chunks = {
            f"pairs_{i:05d}": self.pairs[i * pairs_per_step:
                                         (i + 1) * pairs_per_step]
            for i in range((len(self.pairs) + pairs_per_step - 1)
                           // pairs_per_step)}
        self._feats: Dict[str, Dict[str, np.ndarray]] = {}
        # the manifest records chunk names only, so a manifest from another
        # pair list, chunking or RANSAC config would skip work on resume:
        # fingerprint the job config into the name
        digest = hashlib.sha1(json.dumps(
            [self.pairs, pairs_per_step, self._params, seed],
            default=str).encode()).hexdigest()[:8]
        super().__init__(store, f"match_{algorithm}_{digest}",
                         items=sorted(self._chunks),
                         manifest_path=manifest_path)

    def _features(self, scene: str) -> Dict[str, np.ndarray]:
        if scene not in self._feats:
            self._feats[scene] = load_scene_features(self.store, scene,
                                                     self.algorithm)
        return self._feats[scene]

    @functools.cached_property
    def _solver(self):
        return make_pair_solver(*self._params, device=self.device)

    @functools.cached_property
    def _mesh_solvers(self):
        """One solver per distinct device of the mesh, and the runner."""
        return ({d: make_pair_solver(*self._params, device=d)
                 for d in dict.fromkeys(self.mesh)}, MeshRunner(self.mesh))

    def _solve_on_mesh(self, batch: List, draws) -> Dict[str, np.ndarray]:
        solvers, runner = self._mesh_solvers
        shards = dict(_shard_batch(batch + [draws], self.mesh))

        def work(i):
            yield "pairs", solvers[self.mesh[i]](*shards[i])

        parts = runner.run(work, list(shards))
        return {k: np.concatenate([p["pairs"][k].cpu().numpy()
                                   for p in parts])
                for k in parts[0]["pairs"]}

    def process(self, name: str) -> None:
        chunk = self._chunks[name]
        fa = [self._features(a) for a, _ in chunk]
        fb = [self._features(b) for _, b in chunk]
        iters = self._params[3]
        draws = np.stack([
            matching.uniform_draws((iters,), self.seed,
                                   self._pair_index[p]).numpy()
            for p in chunk])
        batch = [np.stack([f[k] for f in fs]) for fs in (fa, fb)
                 for k in ("ys", "xs", "desc", "valid")]
        if self.mesh is not None:
            out = self._solve_on_mesh(batch, draws)
        else:
            out = {k: v.cpu().numpy()
                   for k, v in self._solver(*batch, draws).items()}
        for i, (a, b) in enumerate(chunk):
            self.store.put_result(self._result_name(a, b), {
                "t": out["t"][i], "n_inliers": out["n_inliers"][i],
                "n_matches": out["n_matches"][i], "rms": out["rms"][i]})

    def _result_name(self, a: str, b: str) -> str:
        # job-qualified (algorithm + config digest): two configs sharing a
        # store never alias each other's pair registrations
        return f"{pair_name(a, b)}.{self.job_name}"

    def results(self) -> Dict[Tuple[str, str], Dict[str, np.ndarray]]:
        return {(a, b): self.store.get_result(self._result_name(a, b))
                for a, b in self.pairs
                if self.store.has_result(self._result_name(a, b))}


def solve_layout(scene_names: Sequence[str],
                 pair_results: Dict[Tuple[str, str], Dict],
                 min_inliers: int = 8):
    """Absolute scene positions from verified pairwise offsets.

    Registration gives ``t = O_a - O_b`` per pair, so a BFS spanning tree
    from the anchor (the first scene) propagates ``O_b = O_a - t``.  Pairs
    under ``min_inliers`` are dropped as unverified; scenes the remaining
    graph cannot reach are left out of the positions.

    Returns (positions {scene: [y, x] float64}, dropped_pairs)."""
    adj: Dict[str, List[Tuple[str, np.ndarray]]] = {n: [] for n in scene_names}
    dropped = []
    for (a, b), r in pair_results.items():
        if int(r["n_inliers"]) < min_inliers:
            dropped.append((a, b))
            continue
        t = np.asarray(r["t"], np.float64)
        adj[a].append((b, -t))       # O_b = O_a - t
        adj[b].append((a, t))        # O_a = O_b + t
    anchor = scene_names[0]
    positions = {anchor: np.zeros(2)}
    queue = deque([anchor])
    while queue:
        cur = queue.popleft()
        for nxt, delta in adj[cur]:
            if nxt not in positions:
                positions[nxt] = positions[cur] + delta
                queue.append(nxt)
    return positions, dropped


def mosaic_summary(positions: Dict[str, np.ndarray],
                   scene_hw: Tuple[int, int]) -> Dict:
    """Mosaic layout: normalized per-scene offsets and the canvas size."""
    if not positions:
        return {"n_scenes": 0, "mosaic_hw": (0, 0), "offsets": {}}
    pos = np.stack(list(positions.values()))
    origin = pos.min(axis=0)
    extent = pos.max(axis=0) - origin + np.asarray(scene_hw, np.float64)
    return {
        "n_scenes": len(positions),
        "mosaic_hw": (int(np.ceil(extent[0])), int(np.ceil(extent[1]))),
        "offsets": {k: (float(v[0] - origin[0]), float(v[1] - origin[1]))
                    for k, v in positions.items()},
    }
