"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell names a configuration (``portbench/configs/<name>.json``) and a
traffic mix (``portbench/traffic/<name>.json``).  Set-up draws the mix's
pool of scenes on the card from the seed, cuts them into the
configuration's halo tiles and runs one warm scene, in which the program
loads its kernels (built once per checkout, under ``build/``).  The window then
sends scenes back to back from one client (a closed loop, one scene in
flight), cycling the pool, each pool scene at least once: a scene is one call of
``repro_torch.core.engine.extract_features_multi`` over all its tiles, and
ends when every requested algorithm's result is on the host, copied into
page-locked tensors made in set-up (`Landing`).  A cell of n > 1
cards runs ``engine.make_distributed_multi_extractor`` over
``data_mesh(n)`` instead: each pool scene is drawn on the first card as
before, then staged as ``Sharded`` batches, its rows split over the cards
and resident there, and the results land on the first card.  With
``--trace 1`` a few scenes run under ``torch.profiler`` instead, and the
cell's per-layer metrics are read from that window.

After the window the program's results for a sample of the scenes, drawn
from the seed (up to ``CHECK_PER_SLOT`` runs of each of a few pool slots),
are compared with the plain reference
(``portbench/reference/difet.py``) run on the same tiles
(``portbench/compare.py``).  The last line of standard output is the JSON
result; the numbers compared, each beside its limit, are the last lines of
standard error.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
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
    return cell, cfg, traffic


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


def program_entry(cfg: dict, algorithms, mesh=None):
    """The timed entry of the system under test: one scene's tiles and
    headers (on the device; over ``mesh``, `Sharded` batches on it) ->
    {algorithm: result}."""
    from repro_torch.core import engine
    dc = difet_config(cfg)
    algs = tuple(algorithms)
    if mesh is not None:
        return engine.make_distributed_multi_extractor(algs, dc, mesh)

    def entry(tiles, headers):
        return engine.extract_features_multi(tiles, headers, algs, dc,
                                             device=tiles.device)
    return entry


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


def measure(cfg: dict, traffic: dict, seed: int, seconds: float,
            trace: bool, device, entry, e2e=(), per_layer=(),
            t_start=None, marks=(), root: Path = ROOT, mesh=None):
    """Set-up, the window (or the traced scenes), and the check: returns
    (result, compared values) where result has the keys ``correct``,
    ``attempted``, ``failed``, ``metrics``, on CUDA
    ``memory_peak_bytes_per_card`` and, traced, ``trace``.  ``marks`` are
    the (stage, clock) of set-up before the call; the set-up's split by
    stage is logged.  Over ``mesh`` (the mesh ``entry`` runs on) the pool
    is drawn on ``device`` and staged on the mesh; the reference runs on
    ``device``."""
    import torch
    from portbench import compare, profiling
    from portbench.reference import difet as reference
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
    pool = make_pool(cfg, traffic, seed, dev, mesh)
    if cuda and mesh is not None:
        torch.cuda.empty_cache()       # what the staging left on ``dev``
    sync()
    marks.append(("pool", time.perf_counter()))
    n_pool = len(pool)
    check = set(random.Random(seed).sample(
        range(n_pool), min(traffic["check_slots"], n_pool)))
    with torch.no_grad():
        warm = entry(*pool[0])                   # the warm scene
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
            while t_end < deadline or i < n_pool:     # the pool at least once
                slot = i % n_pool
                a = time.perf_counter()
                landing(slot, entry(*pool[slot]))
                t_end = time.perf_counter()
                latencies.append(t_end - a)
                i += 1
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
            with profiling.recording_calls(modules) as calls:
                with profile(activities=acts) as prof:
                    with record_function(profiling.WINDOW):
                        for i in range(n):
                            with record_function(profiling.SCENE):
                                landing(i % n_pool, entry(*pool[i % n_pool]))
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
    for s in range(n_pool):
        if s not in slots:
            pool[s] = None
    if cuda:
        torch.cuda.empty_cache()
    for s in slots:
        refs[s] = reference.extract(*(whole(x, dev) for x in pool[s]),
                                    traffic["algorithms"], cfg)
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
                          t_start=T_START, marks=marks, mesh=mesh)
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
