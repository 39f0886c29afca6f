"""Synthetic serving traces: one workload definition for the service's
load driver (`launch/serve.py`) and the fleet's.

A copy of ``repro/serve/trace.py`` over the port's own
``data/landsat.py::synthetic_scene``: the same ``TraceConfig`` gives the
same events and bitwise the same tiles.

A trace is a deterministic list of :class:`TraceEvent` — *when* a request
arrives (``t`` seconds from trace start), *what* it asks for (scene,
tile size, algorithm set) and *who* asks (tenant).  The generator models
the load shapes a public feature-extraction service actually sees:

* **arrival processes** — ``uniform`` (fixed inter-arrival), ``poisson``
  (exponential inter-arrival at the same mean rate), and ``burst``
  (Markov-modulated: the rate alternates between a calm baseline and
  ``burst_factor``× spikes — the pattern that stresses admission
  control);
* **hot-scene skew** — a small hot set of scenes receives most of the
  probability mass (recurring LandSat granules / popular map areas), the
  regime content-hash caches and scene-affinity routing are built for;
* **mixed tile sizes** — requests spread over several shape buckets, so
  batches can't all share one compiled program;
* **multi-tenant mix** — weighted tenants, so per-tenant token buckets
  have someone to throttle.

Everything is driven by one ``numpy`` RNG seeded from ``TraceConfig.seed``
— the same config always yields byte-identical traces, which is what lets
the fleet benchmark replay *the same* trace against 1 and N replicas and
call the throughput ratio a speedup.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.landsat import synthetic_scene

__all__ = ["TraceConfig", "TraceEvent", "make_trace", "tile_pool",
           "scene_key"]


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Knobs for one synthetic trace (all sampling is seeded).

    ``rate`` is the *mean* arrival rate in req/s across every process;
    ``burst`` mode alternates calm (``rate``·(1-burst_amplitude·…)) and
    spike segments so the long-run mean stays ``rate``.  ``hot_weight``
    of the scene-choice mass lands on the first ``ceil(hot_fraction ·
    unique_scenes)`` scenes (the hot set); the rest is uniform over the
    cold set."""
    n_requests: int = 256
    seed: int = 0
    # arrival process
    arrival: str = "uniform"              # uniform | poisson | burst
    rate: float = 500.0                   # mean req/s
    burst_factor: float = 4.0             # spike rate multiplier (burst)
    burst_fraction: float = 0.25          # fraction of requests in spikes
    # workload mix
    tile_sizes: Tuple[int, ...] = (32,)
    tile_size_weights: Optional[Tuple[float, ...]] = None
    unique_scenes: int = 32
    hot_fraction: float = 0.125           # |hot set| / unique_scenes
    hot_weight: float = 0.7               # P(request hits the hot set)
    algorithm_sets: Tuple[Tuple[str, ...], ...] = (("harris",),)
    algorithm_weights: Optional[Tuple[float, ...]] = None
    tenants: Tuple[str, ...] = ("tenant-a",)
    tenant_weights: Optional[Tuple[float, ...]] = None


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One request of a trace: arrival offset + workload coordinates.
    ``scene`` indexes the trace's tile pool (see `tile_pool`)."""
    t: float                              # seconds from trace start
    scene: int
    tile_hw: int
    tenant: str
    algorithms: Tuple[str, ...]

    @property
    def pool_key(self) -> Tuple[int, int]:
        """Key into the `tile_pool` dict for this event's tile."""
        return (self.scene, self.tile_hw)


def scene_key(event: TraceEvent) -> str:
    """The affinity-routing key for an event: same scene (any tile size)
    → same key → same replica under consistent-hash routing."""
    return f"scene-{event.scene}"


def _weights(n: int, w: Optional[Sequence[float]]) -> np.ndarray:
    if w is None:
        return np.full((n,), 1.0 / n)
    w = np.asarray(w, np.float64)
    if w.shape != (n,):
        raise ValueError(f"need {n} weights, got {w.shape}")
    return w / w.sum()


def _arrival_offsets(cfg: TraceConfig, rng: np.random.RandomState
                     ) -> np.ndarray:
    """Cumulative arrival times (seconds) for ``n_requests`` events."""
    n, mean_gap = cfg.n_requests, 1.0 / cfg.rate
    if cfg.arrival == "uniform":
        gaps = np.full((n,), mean_gap)
    elif cfg.arrival == "poisson":
        gaps = rng.exponential(mean_gap, size=n)
    elif cfg.arrival == "burst":
        # Markov-modulated: ``burst_fraction`` of requests arrive at
        # ``burst_factor``× the base rate, the rest slower, so the
        # long-run mean rate stays cfg.rate:
        #   f/r_spike + (1-f)/r_calm = 1/rate
        f, k = cfg.burst_fraction, cfg.burst_factor
        calm_gap = mean_gap * (1.0 - f / k) / max(1.0 - f, 1e-9)
        spike = rng.rand(n) < f
        gaps = np.where(spike, mean_gap / k, calm_gap)
        # arrivals cluster: sort spike membership into runs of ~8 so a
        # spike is a sustained burst, not isolated fast gaps
        run = 8
        for i in range(0, n - run, run):
            if spike[i]:
                gaps[i:i + run] = mean_gap / k
    else:
        raise ValueError(f"unknown arrival process {cfg.arrival!r} "
                         f"(uniform | poisson | burst)")
    return np.cumsum(gaps)


def make_trace(cfg: TraceConfig) -> List[TraceEvent]:
    """Generate the trace: deterministic in ``cfg`` (same config ⇒ same
    events, byte for byte)."""
    rng = np.random.RandomState(cfg.seed)
    t = _arrival_offsets(cfg, rng)
    n = cfg.n_requests
    # hot-scene skew: hot set gets hot_weight of the mass
    n_hot = max(1, int(np.ceil(cfg.hot_fraction * cfg.unique_scenes)))
    n_hot = min(n_hot, cfg.unique_scenes)
    p = np.empty((cfg.unique_scenes,))
    p[:n_hot] = cfg.hot_weight / n_hot
    if cfg.unique_scenes > n_hot:
        p[n_hot:] = (1.0 - cfg.hot_weight) / (cfg.unique_scenes - n_hot)
    else:
        p[:n_hot] = 1.0 / n_hot
    scenes = rng.choice(cfg.unique_scenes, size=n, p=p / p.sum())
    sizes = rng.choice(len(cfg.tile_sizes), size=n,
                       p=_weights(len(cfg.tile_sizes),
                                  cfg.tile_size_weights))
    algs = rng.choice(len(cfg.algorithm_sets), size=n,
                      p=_weights(len(cfg.algorithm_sets),
                                 cfg.algorithm_weights))
    tenants = rng.choice(len(cfg.tenants), size=n,
                         p=_weights(len(cfg.tenants), cfg.tenant_weights))
    return [TraceEvent(t=float(t[i]), scene=int(scenes[i]),
                       tile_hw=int(cfg.tile_sizes[sizes[i]]),
                       tenant=cfg.tenants[tenants[i]],
                       algorithms=tuple(cfg.algorithm_sets[algs[i]]))
            for i in range(n)]


def tile_pool(cfg: TraceConfig) -> Dict[Tuple[int, int], np.ndarray]:
    """The trace's tile inventory: one synthetic grayscale tile per
    (scene, tile size) the trace can reference.  Tile content depends on
    (trace seed, scene, size) only, so two traces with the same seed share
    bit-identical tiles — required for cross-run parity checks."""
    pool = {}
    for scene in range(cfg.unique_scenes):
        for hw in cfg.tile_sizes:
            pool[(scene, hw)] = synthetic_scene(
                hw, hw, seed=cfg.seed * 100003 + scene * 31 + hw)
    return pool
