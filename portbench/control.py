"""The readings that the limits of ``compare.py`` are set from, at a
cell's own size on the card.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3

For each seed, the first scene of the cell's pool (as ``run.py`` draws
and, on a mesh, stages it) goes through the program's timed entry (over the
cell's mesh on a cell of more than one card), the plain reference, and, for
the control seeds, the control: the reference computed in bfloat16 and put
in the program's place.  Each is compared with the reference as a run
compares it.  Prints one JSON line per seed, then the largest reading of
the program (the lower reading of each limit) and the smallest of the
control (the upper reading).
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]

from portbench import compare, run  # noqa: E402
from portbench.reference import difet as reference  # noqa: E402


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
    algs = traffic["algorithms"]
    one = dict(traffic, pool_scenes=1)
    mesh = run.cell_mesh(cell)
    entry = run.program_entry(cfg, algs, mesh)
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    low = {n: 0 for n in compare.LIMITS}
    high = {n: None for n in compare.LIMITS}
    for seed in seeds:
        t0 = time.perf_counter()
        with torch.no_grad():
            pool = run.make_pool(cfg, one, seed, "cuda:0", mesh)
            got = run.to_host(entry(*pool[0]))
            tiles, headers = (run.whole(x, "cuda:0") for x in pool[0])
            del pool
        want = reference.extract(tiles, headers, algs, cfg)
        line = {"seed": seed, "program": compare.numbers(got, want),
                "total_count": {a: int(want[a]["total_count"])
                                for a in algs}}
        for n, v in line["program"].items():
            low[n] = max(low[n], v)
        if seed in controls:
            c = reference.extract(tiles, headers, algs, cfg,
                                  dtype=torch.bfloat16)
            line["control"] = compare.numbers(c, want)
            line["control_correct"] = compare.verdict(line["control"])
            for n, v in line["control"].items():
                high[n] = v if high[n] is None else min(high[n], v)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    print(json.dumps({"cell": args.workload, "lower": low, "upper": high,
                      "limits": {n: lim for n, (lim, _) in
                                 compare.LIMITS.items()},
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
