#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``.

1. Builds the four CUDA kernels from ``src/repro_torch/kernels/csrc`` with
   nvcc for sm_90a and prints the build seconds and ptxas reports.
2. Holds each kernel against its plain PyTorch twin on the card at the main
   path's shapes (256 tiles of 560^2, SIFT octaves 280/140/70, 131072
   patches of 22^2), an odd unaligned shape, and a tiny octave smaller than
   its pad.
3. Drives the main path: ``extract_features_multi`` over the paper's full
   scene (7681 x 7831, 256 tiles of 560^2, ``DifetConfig()``, all seven
   algorithms) through the kernels, with every launch counter set to 0
   just before and read just after; runs it again and requires bitwise
   equal results; runs the plain route (no kernels) and requires equal
   counts, keypoints and descriptor bits, and float results within
   tolerance.
4. Times each kernel, its twin and a library yardstick where one exists
   (CUDA events, median of 5 after warm-up), each kernel's bound from
   bytes at 3.35 TB/s and fp32 operations at 67 TFLOP/s, a per-stage
   breakdown of the scene, and the end-to-end map/reduce with its peak
   memory, for the scene and for a quarter of it (its first 64 tiles).
5. Prints the kernels JSON line, the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.

Any failure exits non-zero.  Without CUDA, or outside a checkout, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
QUARTER = 64               # tiles of the quarter scene timed beside the scene
REPS = 5                   # timed repetitions (median)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, data sheet
FP32_OPS_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores
CSRC = "src/repro_torch/kernels/csrc"
REPLACES = {
    "harris": "src/repro/kernels/harris.py:44",
    "fast": "src/repro/kernels/fastscore.py:20",
    "blur": "src/repro/kernels/blur.py:18",
    "scalespace": "src/repro/kernels/scalespace.py:65",
}
SOURCES = {"harris": "harris.cu", "fast": "fastscore.cu", "blur": "blur.cu",
           "scalespace": "scalespace.cu"}


def log(*args):
    print(*args, flush=True)


def require(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, reps=REPS, warmup=2):
    """Median device milliseconds of ``fn()`` by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_s(fn, reps):
    """Median host seconds of ``fn()`` ending in a device synchronize."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


# --- the least work each kernel's function needs, from its shapes ---------
def _pass_ops(r):
    """One symmetric 1-D tap pass: r pair adds, r+1 multiplies, r adds."""
    return 3 * r + 1


def harris_work(n, h, w, r, shi):
    grad = (h + 2 * r) * (w + 2 * r) * (2 * 8 + 3)       # 2 Sobel + 3 products
    wpass = 3 * (h + 2 * r) * w * _pass_ops(r)
    hpass = 3 * h * w * _pass_ops(r)
    resp = h * w * (10 if shi else 7)
    return n * (grad + wpass + hpass + resp), n * h * w * 8


def fast_work(n, h, w, arc):
    per = 2 + 16 * 7 + 2 * (2 * (arc - 1) + 2) + 1
    return n * h * w * per, n * h * w * 8


def blur_work(n, h, w, r):
    return n * ((h + 2 * r) * w + h * w) * _pass_ops(r), n * h * w * 8


def scalespace_work(n, h, w, radii):
    m = sum(radii) + 1
    ops = 0
    for r in radii:
        mc = m - r
        ops += (h + 2 * m) * (w + 2 * mc) * _pass_ops(r)  # W pass
        ops += (h + 2 * mc) * (w + 2 * mc) * _pass_ops(r)  # H pass
        ops += (h + 2) * (w + 2)                           # DoG
        m = mc
    # extrema at their least cost: per DoG level a separable 3x3 max and
    # min, 2 ops each in the row pass (over h+2 rows) and in the column pass;
    # a mid level's 8-ring takes one more max and min from the same partial
    # results.  Per mid scale: 2+2 to combine the neighbours, 2 compares and
    # an or, abs, the threshold compare, and, select, and the running max
    # (none for the first mid scale).
    levels, mids = len(radii), len(radii) - 2
    ops += levels * ((h + 2) * w * 4 + h * w * 4) + mids * h * w * 2
    ops += h * w * (12 * mids - 1)
    return n * ops, n * h * w * 12


def bound(work):
    ops, nbytes = work
    t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout (src/repro_torch "
              "not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs.difet_paper import DifetConfig, PAPER_ALGORITHMS
    from repro_torch.core import descriptors as DS
    from repro_torch.core import engine
    from repro_torch.core.bundle import tile_scene
    from repro_torch.core.padding import reflect_pad
    from repro_torch.core.pyramid import (
        downsample2, fused_octave_response, gaussian_kernel_1d,
        octave_increments)
    from repro_torch.data.landsat import synthetic_scene
    from repro_torch.kernels import build, ops, ref

    # the port runs no matmul or convolution; the conv2d yardstick below is
    # held to full fp32 as well
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0))

    # ---- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"build: {len(logs)} kernel libraries built with nvcc "
        f"(sm_90a) from {CSRC} in {time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line:
                log(f"  {name}: {line.strip()}")
    require(all(build.library_path(s).exists() for s in build.SOURCES),
            "a kernel library is missing after the build")

    # ---- inputs: the paper's scene, tiled -----------------------------------
    cfg = DifetConfig()
    t0 = time.perf_counter()
    scene = synthetic_scene(*cfg.scene_hw, seed=0)
    bundle = tile_scene(scene, cfg)
    tiles = torch.from_numpy(bundle.tiles).to(dev)
    headers = torch.from_numpy(bundle.headers).to(dev)
    log(f"scene {cfg.scene_hw} -> {tuple(tiles.shape)} tiles "
        f"({tiles.numel() * 4 / 1e6:.0f} MB on the device), "
        f"set-up {time.perf_counter() - t0:.1f} s")
    require(tiles.shape == (256, 560, 560), "the paper scene must cut into "
            "256 tiles of 560^2")

    # ---- 2. each kernel against its plain twin ------------------------------
    err = {k: 0.0 for k in ops.KERNELS}
    rng = np.random.RandomState(0)

    def hold(name, got, want, rtol, atol, thr=None):
        torch.cuda.synchronize()
        require(got.shape == want.shape, f"{name}: shape {tuple(got.shape)}")
        e = (got - want).abs().max().item()
        ok = torch.allclose(got, want, rtol=rtol, atol=atol)
        same_mask = thr is None or torch.equal(got > thr, want > thr)
        log(f"  {name:28s} {str(tuple(got.shape)):18s} max|err| {e:.3g} "
            f"bitwise {torch.equal(got, want)} (rtol {rtol:g} atol {atol:g})")
        require(ok and same_mask, f"{name}: kernel disagrees with its twin")
        return e

    log("kernels vs plain twins on the card:")
    x = tiles
    odd = torch.from_numpy(rng.rand(3, 61, 200).astype(np.float32)).to(dev)
    for img, tag in ((x, "tiles"), (odd, "odd")):
        for shi in (False, True):
            e = hold(f"harris shi={shi} {tag}",
                     ops.harris(img, k=cfg.harris_k, shi_tomasi=shi),
                     ref.harris(img, k=cfg.harris_k, shi_tomasi=shi),
                     1e-5, 1e-7,
                     thr=engine.ALGORITHMS["shi_tomasi" if shi else "harris"]
                     .threshold(cfg))
            err["harris"] = max(err["harris"], e)
        e = hold(f"fast {tag}", ops.fast_score(img, threshold=cfg.fast_threshold),
                 ref.fast_score(img, threshold=cfg.fast_threshold),
                 1e-5, 1e-6, thr=0.0)
        err["fast"] = max(err["fast"], e)
    base0 = ops.gaussian_blur(x, 1.6)
    kp_shape = (x.shape[0], cfg.max_keypoints_per_tile)
    ys = torch.from_numpy(rng.randint(24, 536, kp_shape)).to(dev)
    xs = torch.from_numpy(rng.randint(24, 536, kp_shape)).to(dev)
    patches = DS.extract_patches(x, ys, xs, 22).reshape(-1, 22, 22)
    blur_cases = [(x, 1.6, "tiles s0"), (x, 2.0, "tiles desc"),
                  (patches, 1.0, "patches"), (odd, 3.2, "odd")]
    blur_cases += [(base0, s, f"octave0 inc{i}")
                   for i, s in enumerate(octave_increments(3, 1.6), 1)]
    for img, sigma, tag in blur_cases:
        e = hold(f"blur s={sigma:.3f} {tag}", ops.gaussian_blur(img, sigma),
                 ref.gaussian_blur(img, sigma), 1e-5, 1e-6)
        err["blur"] = max(err["blur"], e)
    thr = cfg.sift_contrast_threshold / cfg.scales_per_octave
    octave_bases = []
    base = ref.gaussian_blur(x, 1.6)
    for _ in range(3):
        _, seed = fused_octave_response(base, 3, thr)
        base = downsample2(seed)
        octave_bases.append(base)                   # 280^2, 140^2, 70^2
    tiny = octave_bases[-1][:4, :10, :10].contiguous()
    oddb = ref.gaussian_blur(odd[:, :, :199].contiguous(), 1.6)
    for b in octave_bases + [tiny, oddb]:
        got = ops.scalespace_octave(b, scales_per_octave=3, contrast_threshold=thr)
        want = ref.scalespace_octave(b, scales_per_octave=3, contrast_threshold=thr)
        h = b.shape[-1]
        err["scalespace"] = max(
            err["scalespace"],
            hold(f"scalespace resp {h}", got[0], want[0], 0.0, 1e-5, thr=thr),
            hold(f"scalespace seed {h}", got[1], want[1], 0.0, 1e-5))
    torch.cuda.synchronize()

    # ---- 3. the main path ---------------------------------------------------
    def run(use_kernels, n=None):
        return engine.extract_features_multi(
            tiles[:n], headers[:n], PAPER_ALGORITHMS, cfg,
            use_kernels=use_kernels, device=dev)

    log(f"main path: extract_features_multi, {len(PAPER_ALGORITHMS)} "
        f"algorithms, {tiles.shape[0]} tiles at once")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res_k = run(True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    log(f"  kernel route, first run {first_s:.3f} s; launches {launches}")
    for name, n in launches.items():
        require(n >= 1, f"kernel {name} was not launched on the main path")

    res_k2 = run(True)
    for alg in PAPER_ALGORITHMS:
        for key, v in res_k[alg].items():
            require(torch.equal(v, res_k2[alg][key]),
                    f"two kernel-route runs differ in {alg}/{key}")
    log("  two kernel-route runs: bitwise identical")

    res_p = run(False)
    torch.cuda.synchronize()
    exact = ("total_count", "per_tile_count", "top_ys", "top_xs",
             "top_valid", "keypoint_count")
    counts = {}
    for alg in PAPER_ALGORITHMS:
        k, p = res_k[alg], res_p[alg]
        for key in exact:
            require(torch.equal(k[key], p[key]),
                    f"{alg}/{key}: kernel route != plain route")
        require(torch.allclose(k["top_scores"], p["top_scores"],
                               rtol=1e-5, atol=1e-7),
                f"{alg}/top_scores beyond tolerance")
        require(bool(torch.isfinite(k["top_scores"]).all()),
                f"{alg}: non-finite scores")
        require(k["top_ys"].shape == (4 * cfg.max_keypoints_per_tile,),
                f"{alg}: top-K shape")
        if "top_desc" in k:
            if k["top_desc"].dtype == torch.int32:
                require(torch.equal(k["top_desc"], p["top_desc"]),
                        f"{alg}: packed descriptor bits differ")
            else:
                require(bool(torch.isfinite(k["top_desc"]).all()),
                        f"{alg}: non-finite descriptors")
                require(torch.allclose(k["top_desc"], p["top_desc"],
                                       rtol=1e-5, atol=1e-5),
                        f"{alg}: float descriptors beyond tolerance")
        counts[alg] = int(k["total_count"])
    log("  plain route agrees: counts, keypoints, valid flags and packed "
        "bits equal; scores and float descriptors within 1e-5")
    log("table2_counts " + json.dumps(counts))

    # ---- 4. timings ---------------------------------------------------------
    log("timings (median of %d, CUDA events):" % REPS)
    n, h, w = x.shape
    r_h = (len(gaussian_kernel_1d(1.0)) - 1) // 2
    rows = {}
    rows["harris"] = dict(
        ms=cuda_ms(lambda: ops.harris(x, k=cfg.harris_k)),
        plain_ms=cuda_ms(lambda: ref.harris(x, k=cfg.harris_k)),
        work=harris_work(n, h, w, r_h, False), library_ms=None,
        shape=f"[{n},{h},{w}] harris")
    rows["fast"] = dict(
        ms=cuda_ms(lambda: ops.fast_score(x, threshold=cfg.fast_threshold)),
        plain_ms=cuda_ms(lambda: ref.fast_score(x, threshold=cfg.fast_threshold)),
        work=fast_work(n, h, w, cfg.fast_arc), library_ms=None,
        shape=f"[{n},{h},{w}]")
    taps = gaussian_kernel_1d(1.6)
    r_b = (len(taps) - 1) // 2
    xp = reflect_pad(x, r_b)[:, None]
    w2d = torch.from_numpy(np.outer(taps, taps)).to(dev)[None, None]
    rows["blur"] = dict(
        ms=cuda_ms(lambda: ops.gaussian_blur(x, 1.6)),
        plain_ms=cuda_ms(lambda: ref.gaussian_blur(x, 1.6)),
        library_ms=cuda_ms(lambda: F.conv2d(xp, w2d)),
        work=blur_work(n, h, w, r_b), shape=f"[{n},{h},{w}] sigma 1.6")
    b1 = octave_bases[0]
    radii = [(len(gaussian_kernel_1d(s)) - 1) // 2
             for s in octave_increments(3, 1.6)]
    rows["scalespace"] = dict(
        ms=cuda_ms(lambda: ops.scalespace_octave(
            b1, scales_per_octave=3, contrast_threshold=thr)),
        plain_ms=cuda_ms(lambda: ref.scalespace_octave(
            b1, scales_per_octave=3, contrast_threshold=thr)),
        work=scalespace_work(*b1.shape, radii), library_ms=None,
        shape=f"[{b1.shape[0]},{b1.shape[1]},{b1.shape[2]}] octave 1")
    extra = {
        "harris shi_tomasi": lambda: ops.harris(x, shi_tomasi=True),
        "blur patches s=1.0": lambda: ops.gaussian_blur(patches, 1.0),
        "blur tiles s=2.0": lambda: ops.gaussian_blur(x, 2.0),
        "blur octave0 inc s=%.3f" % octave_increments(3, 1.6)[-1]:
            lambda: ops.gaussian_blur(base0, octave_increments(3, 1.6)[-1]),
        "scalespace octave 2": lambda: ops.scalespace_octave(
            octave_bases[1], scales_per_octave=3, contrast_threshold=thr),
        "scalespace octave 3": lambda: ops.scalespace_octave(
            octave_bases[2], scales_per_octave=3, contrast_threshold=thr),
    }
    for name, row in rows.items():
        row["bound_ms"], row["bound_by"] = bound(row.pop("work"))
        log(f"  {name:10s} {row['shape']:30s} kernel {row['ms']:.4f} ms  "
            f"plain {row['plain_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})  library "
            + ("-" if row["library_ms"] is None else f"{row['library_ms']:.4f} ms"))
    for name, fn in extra.items():
        log(f"  {name:41s} kernel {cuda_ms(fn):.4f} ms")

    # where the time goes: the scene, stage by stage, kernel route
    stage = {}
    resp = {}
    for fn in (engine._harris_resp, engine._shi_resp, engine._sift_resp,
               engine._surf_resp, engine._fast_resp):
        stage[f"response {fn.__name__[1:-5]}"] = cuda_ms(
            lambda fn=fn: fn(x, cfg, True), reps=3, warmup=1)
        resp[fn] = fn(x, cfg, True)
    for alg in PAPER_ALGORITHMS:
        spec = engine.ALGORITHMS[alg]
        stage[f"select+describe {alg}"] = cuda_ms(
            lambda spec=spec: engine._select_and_describe(
                spec, cfg, x, headers, resp[spec.response], True), reps=3,
            warmup=1)
    del resp
    log("breakdown_ms_per_scene " + json.dumps(
        {k: round(v, 4) for k, v in stage.items()}))

    # end to end: the scene, and a quarter of it, each route; the peak is
    # what the run allocates beyond what was held before it
    for n_tiles in (None, QUARTER):
        times = {}
        for route, use in (("kernel", True), ("plain", False)):
            torch.cuda.synchronize()
            base_mem = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t = host_s(lambda: run(use, n_tiles), REPS)
            peak = (torch.cuda.max_memory_allocated() - base_mem) / 2 ** 30
            times[route] = (t, peak)
        nt = n_tiles or tiles.shape[0]
        log(f"end to end, {nt} tiles, 7 algorithms, tiles already on the "
            f"device: kernel route {times['kernel'][0]:.4f} s, peak "
            f"{times['kernel'][1]:.2f} GiB; plain route "
            f"{times['plain'][0]:.4f} s, peak {times['plain'][1]:.2f} GiB "
            f"(medians of {REPS}); {nt / times['kernel'][0]:.1f} tiles/s "
            f"with kernels")

    # device busy share of one kernel-route run, and its costliest kernels
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_us = {ev.key: ev.self_device_time_total
                 for ev in prof.key_averages()
                 if ev.device_type == torch.autograd.DeviceType.CUDA}
    busy = sum(device_us.values()) / 1e6
    if busy > 0:
        top = sorted(device_us.items(), key=lambda kv: -kv[1])[:12]
        log(f"profile (one kernel-route run under the profiler): device busy "
            f"{busy:.4f} s of {wall:.4f} s wall, {100 * busy / wall:.1f}%")
        for key, us in top:
            log(f"  {us / 1e3:9.3f} ms  {key[:100]}")
    else:
        log("profile: the profiler recorded no device time; the busy share "
            "is not measured")

    # ---- 5. results ---------------------------------------------------------
    kernels = []
    for name in ("harris", "fast", "blur", "scalespace"):
        row = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"{CSRC}/{SOURCES[name]}", "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": err[name],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(json.dumps({"kernels": kernels}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
