"""The readings that the limits of ``compare.py`` are set from, at a
cell's own size on the card.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3

For each seed, the first scene of the cell's pool (as ``run.py`` draws
and, on a mesh, stages it; for ``band_files`` input, writes it to disk)
goes through the program's timed entry (over the cell's mesh on a cell of
more than one card), the plain reference (for band files on the plain
tiler's tiles of the same files), and, for the control seeds, the control:
the reference computed in bfloat16 and put in the program's place.  Each
is compared with the reference as a run compares it.  Prints one JSON line
per seed, then the largest reading of the program (the lower reading of
each limit) and the smallest of the control (the upper reading).
"""
import argparse
import json
import shutil
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]

from portbench import compare, run  # noqa: E402
from portbench.reference import bands  # noqa: E402
from portbench.reference import difet as reference  # noqa: E402


def readings(cfg: dict, traffic: dict, seed: int, entry, device="cuda:0",
             mesh=None, control: bool = False, where=None) -> dict:
    """One seed's line: the numbers of the program's answer for the first
    pool scene and, where ``control``, the control's, each against the
    reference.  Band files are written under ``where`` (by default
    ``build/portbench/scenes/control-<seed>``) and removed."""
    import torch
    algs = traffic["algorithms"]
    one = dict(traffic, pool_scenes=1)
    t0 = time.perf_counter()
    with torch.no_grad():
        if run.input_kind(cfg) == "resident":
            pool = run.make_pool(cfg, one, seed, device, mesh)
            got = run.to_host(entry(*pool[0]))
            tiles, headers = (run.whole(x, device) for x in pool[0])
            del pool
        else:
            where = Path(where or run.ROOT / "build" / "portbench" / "scenes"
                         / f"control-{seed}")
            try:
                dirs = run.write_pool(cfg, one, seed, device, where)
                scenes = iter(entry(dirs))
                try:
                    got = run.to_host(next(scenes))
                finally:
                    run.close_job(scenes)
                tiles, headers = (torch.from_numpy(x).to(device) for x in
                                  bands.tile_scene(dirs[0], cfg["tile"],
                                                   cfg["halo"]))
            finally:
                shutil.rmtree(where, ignore_errors=True)
    want = reference.extract(tiles, headers, algs, cfg)
    line = {"seed": seed, "program": compare.numbers(got, want),
            "total_count": {a: int(want[a]["total_count"]) for a in algs}}
    if control:
        c = reference.extract(tiles, headers, algs, cfg,
                              dtype=torch.bfloat16)
        line["control"] = compare.numbers(c, want)
        line["control_correct"] = compare.verdict(line["control"])
    line["seconds"] = time.perf_counter() - t0
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: no card", file=sys.stderr)
        return 3
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    cell, cfg, traffic = run.cell_spec(bench, args.workload)
    mesh = run.cell_mesh(cell)
    entry = run.program_entry(cfg, traffic["algorithms"], mesh)
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    low = {n: 0 for n in compare.LIMITS}
    high = {n: None for n in compare.LIMITS}
    for seed in seeds:
        line = readings(cfg, traffic, seed, entry, "cuda:0", mesh,
                        seed in controls)
        for n, v in line["program"].items():
            low[n] = max(low[n], v)
        for n, v in line.get("control", {}).items():
            high[n] = v if high[n] is None else min(high[n], v)
        print(json.dumps(line), flush=True)
    print(json.dumps({"cell": args.workload, "lower": low, "upper": high,
                      "limits": {n: lim for n, (lim, _) in
                                 compare.LIMITS.items()},
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
