"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell names a configuration (``portbench/configs/<name>.json``) and a
traffic mix (``portbench/traffic/<name>.json``).  Set-up draws the mix's
pool of scenes from the seed and runs one warm scene, in which the program
loads its kernels (built once per checkout, under ``build/``).  The window
then sends scenes back to back from one client (a closed loop, one scene in
flight), cycling the pool, each pool scene at least once.  A scene ends
when every requested algorithm's result is on the host, copied into
page-locked tensors made in set-up (`Landing`).

Where the scenes live is the configuration's ``input``:

* ``resident`` (the default): each pool scene is drawn on the card and cut
  into the configuration's halo tiles there, and stays resident.  A scene
  is one call of the program's entry on its tiles and headers:
  ``repro_torch.core.engine.extract_features_multi``, or, on a cell of
  n > 1 cards, ``engine.make_distributed_multi_extractor`` over
  ``data_mesh(n)``, each pool scene drawn on the first card and staged as
  ``Sharded`` batches, its rows split over the cards and resident there,
  the results landing on the first card.  ``scene_s`` is the window's
  seconds over the scenes it ran, ``scene_p90_s`` the 90th percentile of a
  scene's time from its call to its landing.
* ``band_files``: set-up writes each pool scene to disk as LandSat-8's
  visible bands (`scenes.write_bands`: ``scene.json`` and ``B4.npy``,
  ``B3.npy``, ``B2.npy``, uint8) under
  ``build/portbench/scenes/<cell>-<seed>/``, synced, and removed when the
  run ends.  The window is one job over the pool's directories, cycled:
  by default the program's streamed route as
  ``repro_torch.launch.scale.run_worker`` composes it
  (``BandSceneReader``, then ``iter_tile_batches`` with one scene's tiles a
  batch packed into pinned memory, then a ``Prefetcher`` staging each batch
  on the card or the mesh, then the extractor above), closed at the
  deadline.  ``scene_s`` is the window's seconds over the scenes landed,
  ``scene_p90_s`` the 90th percentile of the time from the previous
  landing, or from the window's start, to a scene's landing.

A configuration's optional ``entry``, ``"module:function"``, names the
program's factory that set-up imports instead: ``factory(algorithms,
DifetConfig, mesh)`` returns ``run(tiles, headers) -> {algorithm:
result}`` for ``resident`` input, and ``run(scene_dirs) -> iterator of
{algorithm: result}`` (each result on the first card) for ``band_files``.
A factory that the program lacks ends the run before any scene, with one
line that names it and a code other than 0.

With ``--trace 1`` a few scenes (the traffic's ``trace_scenes``; of a
job started under the profiler, those after its first) run under
``torch.profiler`` instead, and the cell's per-layer metrics are read from
that window.

After the window the program's results for a sample of the scenes, drawn
from the seed (up to ``CHECK_PER_SLOT`` runs of each of a few pool slots),
are compared with the plain reference
(``portbench/reference/difet.py``) run on the same tiles: for band files
cut by the plain tiler ``portbench/reference/bands.py`` from the same
files (``portbench/compare.py``).  The last line of standard output is the
JSON result; the numbers compared, each beside its limit, are the last
lines of standard error.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "portbench":
    sys.path.pop(0)          # run as a script: no module of ours shadows
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

BANNED = ("jax", "jaxlib", "flax", "repro")     # the JAX package and its stack


def log(*args):
    print("portbench:", *args, file=sys.stderr, flush=True)


def banned_modules():
    """Loaded top-level modules that the program must never load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def load_json(path: Path):
    return json.loads(path.read_text())


def cell_spec(bench: dict, name: str, root: Path = ROOT):
    """(cell, configuration, traffic) of the cell ``name``, the files
    found under ``root``."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"portbench: no cell {name!r}; cells: "
                         f"{', '.join(cells)}")
    cell = cells[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(root / cfgs[cell["config"]]["file"])
    traffic = load_json(root / "portbench" / "traffic"
                        / f"{cell['traffic']}.json")
    if traffic.get("kind") != "closed_loop" or traffic.get("clients") != 1:
        raise SystemExit(f"portbench: traffic {cell['traffic']!r}: only a "
                         f"closed loop of one client is generated")
    if input_kind(cfg) not in INPUTS:
        raise SystemExit(f"portbench: configuration {cell['config']!r}: "
                         f"input {cfg['input']!r} is none of "
                         f"{', '.join(INPUTS)}")
    return cell, cfg, traffic


INPUTS = ("resident", "band_files")     # where a configuration's scenes live


def input_kind(cfg: dict) -> str:
    return cfg.get("input", "resident")


def cell_metrics(bench: dict, name: str):
    """(end-to-end, per-layer) metric entries that the cell reports: an
    end-to-end metric without ``workloads`` is every cell's; a per-layer
    metric names its cells."""
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    for m in bench["per_layer"]:
        if "workloads" not in m:
            raise SystemExit(f"portbench: the per-layer metric "
                             f"{m['name']!r} lists no workloads")
    return e2e, [m for m in bench["per_layer"] if name in m["workloads"]]


def _load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: Path = ROOT):
    """``read(trace)`` of a per-layer metric: ``metrics/<name>.py``; else,
    for ``<part>_<family>``, ``metrics/<family>.py`` read with ``part``
    (``blur_roofline``: ``metrics/roofline.py`` with ``blur``)."""
    base = root / "portbench" / "metrics"
    if (base / f"{name}.py").exists():
        return _load_file(base / f"{name}.py",
                          f"portbench.metrics.{name}").read
    part, _, family = name.rpartition("_")
    path = base / f"{family}.py"
    if not part or not path.exists():
        raise SystemExit(f"portbench: no reader for the metric {name!r}")
    fn = _load_file(path, f"portbench.metrics.{family}").read
    return lambda trace: fn(trace, part)


def difet_config(cfg: dict):
    """The program's ``DifetConfig`` of a configuration file."""
    from repro_torch.configs.difet_paper import DifetConfig
    fields = {f.name for f in dataclasses.fields(DifetConfig)}
    return DifetConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in cfg.items() if k in fields})


def cell_mesh(cell: dict):
    """The program's ``data_mesh`` of a cell of more than one card, or
    None."""
    if cell["chips"] == 1:
        return None
    from repro_torch.distributed.sharding import data_mesh
    return data_mesh(cell["chips"])


def entry_factory(spec: str):
    """The program's factory named ``"module:function"``, imported; a
    factory that the program lacks ends the run with one line naming it."""
    module, sep, name = spec.partition(":")
    try:
        if not (module and sep and name):
            raise ValueError("not of the form module:function")
        factory = getattr(importlib.import_module(module), name)
    except (ImportError, AttributeError, ValueError) as e:
        raise SystemExit(f"portbench: the program has no entry {spec!r} "
                         f"({type(e).__name__}: {e})") from None
    if not callable(factory):
        raise SystemExit(f"portbench: the program's entry {spec!r} is not "
                         f"callable")
    return factory


def program_entry(cfg: dict, algorithms, mesh=None):
    """The timed entry of the system under test: the configuration's
    ``entry`` factory where it names one; else, for ``resident`` input,
    one scene's tiles and headers (on the device; over ``mesh``, `Sharded`
    batches on it) -> {algorithm: result}, and for ``band_files``,
    `band_entry`."""
    if "entry" in cfg:
        return entry_factory(cfg["entry"])(tuple(algorithms),
                                           difet_config(cfg), mesh)
    if input_kind(cfg) == "band_files":
        return band_entry(tuple(algorithms), difet_config(cfg), mesh)
    return extractor(tuple(algorithms), difet_config(cfg), mesh)


def extractor(algs, dc, mesh=None):
    """The program's extractor of one batch of tiles and headers."""
    from repro_torch.core import engine
    if mesh is not None:
        return engine.make_distributed_multi_extractor(algs, dc, mesh)

    def entry(tiles, headers):
        return engine.extract_features_multi(tiles, headers, algs, dc,
                                             device=tiles.device)
    return entry


def band_entry(algs, dc, mesh=None):
    """``run(scene_dirs)`` -> an iterator of each scene's {algorithm:
    result}: the program's streamed route as ``launch/scale.py::run_worker``
    composes it.  ``BandSceneReader`` (one a directory), then
    ``iter_tile_batches`` with one scene's tiles a batch (all the scenes of
    a configuration have its shape), packed into pinned memory on a card,
    then a ``Prefetcher`` staging each batch on the first card (the CPU
    where there is none) or over ``mesh``, then `extractor`.  Closing the
    iterator closes the prefetcher."""
    import numpy as np
    import torch
    from repro_torch.data.landsat import BandSceneReader
    from repro_torch.data.pipeline import (Prefetcher, iter_tile_batches,
                                           pinned_empty, scene_tile_count)
    fn = extractor(algs, dc, mesh)
    if mesh is not None:
        device, staging = torch.device(mesh[0]), {"mesh": mesh}
    else:
        device = torch.device("cuda:0" if torch.cuda.is_available()
                              else "cpu")
        staging = {"device": device}
    alloc = pinned_empty if device.type == "cuda" else np.empty

    def run(scene_dirs):
        opened = {}
        for d in dict.fromkeys(map(str, scene_dirs)):
            opened[d] = BandSceneReader(d)
        readers = [opened[str(d)] for d in scene_dirs]
        batches = iter_tile_batches(
            readers, dc, scene_tile_count(readers[0].shape, dc), alloc=alloc)
        with Prefetcher(batches, device_put=True, **staging) as pf:
            for _, bundle in pf:
                yield fn(bundle.tiles, bundle.headers)
    return run


def to_host(result: dict) -> dict:
    return {alg: {k: v.cpu() for k, v in r.items()}
            for alg, r in result.items()}


CHECK_PER_SLOT = 32      # results kept for the check, a checked slot


def host_rows(result: dict, rows=None, pin=False) -> dict:
    """Empty host tensors shaped as ``result``'s fields, behind a leading
    axis of ``rows`` where given; page-locked where ``pin``."""
    import torch
    lead = () if rows is None else (rows,)
    return {alg: {k: torch.empty(lead + tuple(v.shape), dtype=v.dtype,
                                 pin_memory=pin) for k, v in r.items()}
            for alg, r in result.items()}


def land(result: dict, dst: dict) -> dict:
    """``result`` copied into the host tensors ``dst`` (a field of another
    shape or type into a new tensor), returned once all of it is on the
    host: the end of a scene."""
    import torch
    out, cards = {}, set()
    for alg, r in result.items():
        out[alg] = {}
        for k, v in r.items():
            d = dst.get(alg, {}).get(k)
            if d is None or d.shape != v.shape or d.dtype != v.dtype:
                d = torch.empty(v.shape, dtype=v.dtype)
            out[alg][k] = d.copy_(v, non_blocking=True)
            if v.is_cuda:
                cards.add(v.device)
    for c in cards:
        torch.cuda.current_stream(c).synchronize()
    return out


class Landing:
    """Where each scene's result lands on the host.  For each checked slot
    a uniform sample, drawn from the seed, of at most ``per_slot`` of the
    scenes that ran it (reservoir sampling) lands straight in its row of
    a store made in set-up; every other scene lands in one reused set of
    tensors.  All of it is page-locked on a card, so every scene costs the
    host the same copy and the window touches no new host memory."""

    def __init__(self, like: dict, check, seed: int,
                 per_slot: int = CHECK_PER_SLOT, pin: bool = False):
        self.per_slot = per_slot
        self.scratch = host_rows(like, None, pin)
        self.rows = {}
        for s in check:
            store = host_rows(like, per_slot, pin)
            self.rows[s] = [{alg: {k: v[j] for k, v in r.items()}
                             for alg, r in store.items()}
                            for j in range(per_slot)]
        self.seen = dict.fromkeys(check, 0)
        self.rng = random.Random(f"{seed} kept")
        self.kept = {}

    def __call__(self, slot: int, result: dict) -> dict:
        j = None
        if slot in self.seen:
            c = self.seen[slot]
            self.seen[slot] = c + 1
            j = c if c < self.per_slot else self.rng.randrange(c + 1)
            j = j if j < self.per_slot else None
        if j is None:
            return land(result, self.scratch)
        self.kept[slot, j] = land(result, self.rows[slot][j])
        return self.kept[slot, j]

    def items(self):
        """[(slot, result)] of the scenes kept, in slot order."""
        return [(s, r) for (s, _), r in sorted(self.kept.items())]


def make_pool(cfg: dict, traffic: dict, seed: int, device, mesh=None):
    """The traffic's pool of scenes, as [(tiles, headers)] drawn on
    ``device``; over ``mesh``, each staged as `Sharded` batches on it, and
    nothing of the whole scene left on ``device``."""
    import torch
    from portbench import scenes
    gen = scenes.generator(seed, device)
    h, w = cfg["scene_hw"]
    pool = []
    with torch.no_grad():
        for _ in range(traffic["pool_scenes"]):
            gray = scenes.synthetic_scene(h, w, gen)
            tiles, headers = scenes.tile_scene(gray, cfg["tile"], cfg["halo"])
            if mesh is not None:
                tiles = _staged(tiles, mesh, torch.float32)
                headers = _staged(headers, mesh, torch.int32)
            pool.append((tiles, headers))
    return pool


def _staged(x, mesh, dtype):
    """``sharding.shard(x, mesh, dtype)`` with no part sharing ``x``'s
    storage: a part on ``x``'s own device is a view of the whole batch,
    which would keep all of it resident there."""
    from repro_torch.distributed.sharding import Sharded, shard
    whole = x.untyped_storage().data_ptr()
    return Sharded([p.clone() if p.untyped_storage().data_ptr() == whole
                    else p for p in shard(x, mesh, dtype).parts], mesh)


def whole(x, device):
    """A batch on ``device``: a `Sharded` batch's parts gathered in
    order."""
    import torch
    parts = getattr(x, "parts", None)
    if parts is None:
        return x.to(device)
    return torch.cat([p.to(device) for p in parts])


def write_pool(cfg: dict, traffic: dict, seed: int, device, where: Path):
    """The traffic's pool of scenes written to disk as band files: each
    scene drawn on ``device`` as `make_pool` draws it, its visible bands
    (`scenes.band_scene`) stored under ``where/scene_<i>`` and synced.
    Returns the scene directories."""
    import torch
    from portbench import scenes
    gen = scenes.generator(seed, device)
    h, w = cfg["scene_hw"]
    if where.exists():
        shutil.rmtree(where)
    dirs = []
    with torch.no_grad():
        for i in range(traffic["pool_scenes"]):
            bands = scenes.band_scene(scenes.synthetic_scene(h, w, gen))
            dirs.append(scenes.write_bands(where, f"scene_{i}",
                                           bands.cpu().numpy()))
            del bands
    return dirs


def job(pool: list, n: int) -> list:
    """``n`` scenes of the pool, cycled: scene ``i`` is slot ``i % len``."""
    return [pool[i % len(pool)] for i in range(n)]


WARM_SCENES = 4          # a job's warm scenes: the prefetcher's depth + 2
JOB_SCENES_PER_S = 1000  # a window's job is longer than it can run


def close_job(it):
    """Close a job's iterator where it can be closed (a generator)."""
    close = getattr(it, "close", None)
    if close is not None:
        close()


def measure(cfg: dict, traffic: dict, seed: int, seconds: float,
            trace: bool, device, entry, e2e=(), per_layer=(),
            t_start=None, marks=(), root: Path = ROOT, mesh=None,
            name: str = "cell", scenes_dir=None):
    """Set-up, the window (or the traced scenes), and the check: returns
    (result, compared values) where result has the keys ``correct``,
    ``attempted``, ``failed``, ``metrics``, on CUDA
    ``memory_peak_bytes_per_card`` and, traced, ``trace``.  ``marks`` are
    the (stage, clock) of set-up before the call; the set-up's split by
    stage is logged.  Over ``mesh`` (the mesh ``entry`` runs on) the pool
    is drawn on ``device`` and staged on the mesh; the reference runs on
    ``device``.  For ``band_files`` input the pool is written under
    ``scenes_dir`` (by default ``build/portbench/scenes/<name>-<seed>``
    under ``root``), removed before the call returns."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    marks = list(marks)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    cards = sorted({d.index for d in (mesh or [dev])}) if cuda else None

    def sync():
        for c in cards or ():
            torch.cuda.synchronize(c)

    if cuda:
        for c in cards:
            torch.empty(1, device=torch.device("cuda", c))
        sync()
        marks.append(("CUDA context", time.perf_counter()))
    if input_kind(cfg) == "resident":
        pool = make_pool(cfg, traffic, seed, dev, mesh)
        if cuda and mesh is not None:
            torch.cuda.empty_cache()       # what the staging left on ``dev``
        sync()
        marks.append(("pool", time.perf_counter()))
        return _measure(cfg, traffic, seed, seconds, trace, dev, entry, e2e,
                        per_layer, t_start, marks, root, cards, sync, pool,
                        None)
    where = Path(scenes_dir or root / "build" / "portbench" / "scenes"
                 / f"{name}-{seed}")
    try:
        pool = write_pool(cfg, traffic, seed, dev, where)
        if cuda:
            torch.cuda.empty_cache()       # what the drawing left on ``dev``
        sync()
        marks.append(("band files", time.perf_counter()))
        return _measure(cfg, traffic, seed, seconds, trace, dev, entry, e2e,
                        per_layer, t_start, marks, root, cards, sync, None,
                        pool)
    finally:
        shutil.rmtree(where, ignore_errors=True)


def _measure(cfg, traffic, seed, seconds, trace, dev, entry, e2e, per_layer,
             t_start, marks, root, cards, sync, pool, dirs):
    """`measure` from the warm scene on: over the resident ``pool`` of
    (tiles, headers), or over the band files' directories ``dirs``."""
    import torch
    from portbench import compare, profiling
    from portbench.reference import bands
    from portbench.reference import difet as reference
    cuda = dev.type == "cuda"
    n_pool = len(pool if dirs is None else dirs)
    check = set(random.Random(seed).sample(
        range(n_pool), min(traffic["check_slots"], n_pool)))
    with torch.no_grad():
        if dirs is None:
            warm = entry(*pool[0])                   # the warm scene
            landing = Landing(warm, check, seed, pin=cuda)
            land(warm, landing.scratch)
            del warm
        else:
            landing = None                           # the warm scenes
            for warm in entry(job(dirs, WARM_SCENES)):
                if landing is None:
                    landing = Landing(warm, check, seed, pin=cuda)
                land(warm, landing.scratch)
            del warm
    sync()
    marks.append(("warm scene", time.perf_counter()))
    prev, split = t_start, []
    for stage, t in marks:
        split.append(f"{stage} {t - prev:.2f}")
        prev = t
    log(f"set-up {prev - t_start:.2f} s: " + ", ".join(split))
    latencies = []
    out = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    with torch.no_grad():
        if not trace:
            t0 = time.perf_counter()
            setup_s = t0 - t_start
            deadline, t_end, i = t0 + seconds, t0, 0
            if dirs is None:
                while t_end < deadline or i < n_pool:  # the pool at least once
                    slot = i % n_pool
                    a = time.perf_counter()
                    landing(slot, entry(*pool[slot]))
                    t_end = time.perf_counter()
                    latencies.append(t_end - a)
                    i += 1
            else:
                # one job, its scenes timed landing to landing
                scenes = iter(entry(job(
                    dirs, n_pool + int(JOB_SCENES_PER_S * max(seconds, 1)))))
                try:
                    while t_end < deadline or i < n_pool:
                        result = next(scenes, None)
                        if result is None:
                            log("the job ran out of scenes before the "
                                "deadline")
                            break
                        landing(i % n_pool, result)
                        t = time.perf_counter()
                        latencies.append(t - t_end)
                        t_end = t
                        i += 1
                finally:
                    close_job(scenes)
            fifths = [statistics.fmean(latencies[j * len(latencies) // 5:
                                                 (j + 1) * len(latencies)
                                                 // 5] or [0.0])
                      for j in range(5)]
            log("mean scene seconds by fifths of the window: "
                + ", ".join(f"{v:.5f}" for v in fifths))
            known = {"scene_s": (t_end - t0) / len(latencies),
                     "scene_p90_s": statistics.quantiles(
                         latencies, n=10, method="inclusive")[8]
                     if len(latencies) > 1 else latencies[0],
                     "setup_s": setup_s}
            for m in e2e:
                out["metrics"][m["name"]] = {"value": known[m["name"]],
                                             "unit": m["unit"]}
            out["attempted"] = len(latencies)
        else:
            from torch.profiler import ProfilerActivity, profile
            from torch.profiler import record_function
            n = traffic["trace_scenes"]
            modules = profiling.work_modules(root)
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            if dirs is None:
                with profiling.recording_calls(modules) as calls:
                    with profile(activities=acts) as prof:
                        with record_function(profiling.WINDOW):
                            for i in range(n):
                                with record_function(profiling.SCENE):
                                    landing(i % n_pool,
                                            entry(*pool[i % n_pool]))
            else:
                # the job starts under the profiler, and its first scene,
                # which fills the pipeline, lands before the window: the
                # next ``n`` are traced at the pace they keep (a job started
                # before the profiler would find them tiled ahead)
                with profile(activities=acts) as prof:
                    scenes = iter(entry(job(dirs, n + 1)))
                    try:
                        landing(0, next(scenes))
                        with profiling.recording_calls(modules) as calls:
                            with record_function(profiling.WINDOW):
                                for i in range(1, n + 1):
                                    with record_function(profiling.SCENE):
                                        landing(i % n_pool, next(scenes))
                    finally:
                        close_job(scenes)
            tr = profiling.Trace.from_profiler(prof, n, calls, modules,
                                               cards)
            del prof
            for m in per_layer:
                v = reader(m["name"], root)(tr)
                if v is not None:
                    out["metrics"][m["name"]] = {"value": v,
                                                 "unit": m["unit"]}
            out["attempted"] = n
            out["trace"] = tr
    if cuda:
        out["memory_peak_bytes_per_card"] = [
            torch.cuda.max_memory_allocated(c) for c in cards]
    # the check: the program's results are on the host; its pool entries
    # that no sample uses are freed before the reference runs
    kept = landing.items()
    slots = sorted({s for s, _ in kept})
    refs = {}
    if dirs is None:
        for s in range(n_pool):
            if s not in slots:
                pool[s] = None
    if cuda:
        torch.cuda.empty_cache()
    for s in slots:
        if dirs is None:
            tiles, headers = (whole(x, dev) for x in pool[s])
        else:
            # the plain tiler on the same files; the scene id is the
            # slot's first place in the job (the reference reads no id)
            tiles, headers = (torch.from_numpy(x).to(dev) for x in
                              bands.tile_scene(dirs[s], cfg["tile"],
                                               cfg["halo"], s))
        refs[s] = reference.extract(tiles, headers, traffic["algorithms"],
                                    cfg)
        del tiles, headers
    values = compare.worst(compare.numbers(host, refs[s])
                           for s, host in kept)
    out["correct"] = bool(kept) and compare.verdict(values)
    out["compared_scenes"] = len(kept)
    return out, values


def power_limit():
    """The card's power limit as nvidia-smi reads it, or None."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits", "-i", "0"],
                           capture_output=True, text=True, timeout=20)
        return float(r.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # caches at fixed paths inside the checkout; few host threads: set
    # before torch is imported
    cache = ROOT / "build" / "portbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    if not (ROOT / "src" / "repro_torch").is_dir():
        log("the program (src/repro_torch) is not in this checkout")
        return 2
    bench = load_json(ROOT / "BENCHMARK.json")
    cell, cfg, traffic = cell_spec(bench, args.workload)
    e2e, per_layer = cell_metrics(bench, args.workload)
    if "entry" in cfg:
        entry_factory(cfg["entry"])        # one the program lacks ends here
    import torch
    marks = [("torch import", time.perf_counter())]
    if not torch.cuda.is_available():
        log("torch.cuda.is_available() is false")
        return 3
    if torch.cuda.device_count() < cell["chips"]:
        log(f"the cell needs {cell['chips']} card(s), "
            f"{torch.cuda.device_count()} visible")
        return 3
    torch.set_num_threads(1)
    # the program builds each kernel it launches at its first launch, in
    # the warm scene
    mesh = cell_mesh(cell)
    entry = program_entry(cfg, traffic["algorithms"], mesh)
    marks.append(("program import", time.perf_counter()))
    out, values = measure(cfg, traffic, args.seed, args.seconds,
                          bool(args.trace), "cuda:0", entry, e2e, per_layer,
                          t_start=T_START, marks=marks, mesh=mesh,
                          name=args.workload)
    peaks = out["memory_peak_bytes_per_card"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": max(peaks),
              "memory_peak_bytes_per_card": peaks}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": device}
    if args.trace:
        tr = out["trace"]
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        device["per_card_busy_s"] = list(tr.card_busy_s().values())
        result["breakdown"] = tr.breakdown()
    device["power_limit_w"] = power_limit()
    bad = banned_modules()
    if bad:
        log(f"modules of the JAX stack were loaded: {', '.join(bad)}")
        return 4
    log(f"{args.workload} seed {args.seed}: {out['attempted']} scenes, "
        f"{out['compared_scenes']} compared with the reference")
    from portbench import compare
    for name, (limit, what) in compare.LIMITS.items():
        print(f"check {name} = {values[name]!r} (limit {limit!r}): {what}",
              file=sys.stderr, flush=True)
    result["checks"] = compare.report(values)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
