#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, with no arguments: ``python3 chip_smoke.py``
(``--select``: the build and the selection kernel's rows of step 2 alone).

1. Builds the five CUDA kernel libraries from ``src/repro_torch/kernels/csrc``
   with nvcc for sm_90a (one process per source, all at once), prints the
   build seconds and each entry function's registers, shared memory and
   spills from the ptxas report kept beside each library (for libraries
   built by an earlier run as well), and fails on any spill.
2. Holds each kernel against its plain PyTorch twin on the card: blur and
   Harris/Shi-Tomasi bit for bit at the main path's shapes (256 tiles of
   560^2; every blur sigma of the path; 131072 patches of 22^2) and at
   shapes that reach every branch of their design (every radius 1-16 on
   [3, 97, 131], images smaller than their radius, 1001 patches, N = 1, a
   misaligned view that must take the scalar staging); FAST bit for bit
   on the tiles at the scene's threshold 0.15 and the stitch's 0.08, on
   uniform noise (most pixels pass its compass pre-test), on a constant
   image (none does), on [3, 97, 131] (scalar staging), a misaligned view,
   N = 1, images smaller than its pad (3^2, 2^2, 1 x 7), and at every arc
   1-16 at thresholds 0, 0.05 and 0.15; the SIFT octave bit for bit at
   304^2 (octave 0 at tile 256),
   at the higher octaves of a 560^2 tile, at 10^2, at an odd width, for
   three other octaves (2 scales at sigma0 1.6, 3 at 1.2, and 6 at 3.6,
   whose rings let one block on an SM) at 81 x 200 and 304^2, at N = 1, on
   a misaligned view, and at a width one column past the default strip;
   and every octave the wrapper accepts (spo 1-6, sigma0 0.3-6) must get a
   launch geometry from the kernel.  The selection kernel (NMS, ownership,
   count and top-K) bit for bit, every field, on every algorithm's map at
   both benchmark cells' shapes (with its time, least time and the twin's),
   under CUDA-graph capture at a serving bucket, at K 1 and K = H W on
   small tiles, past the shared-memory sort, and on a side stream.
3. Drives the main path: ``extract_features_multi`` over the paper's full
   scene (7681 x 7831, 256 tiles of 560^2, ``DifetConfig()``, all seven
   algorithms) through the kernels, with every launch counter set to 0
   just before and read just after: harris, fast and blur must launch and
   the scale-space kernel must not (octave 0 of a 560^2 tile runs per
   level and no result reads octaves 1-3); runs it again and requires
   bitwise equal results; runs the plain route (no kernels) and requires
   equal counts, keypoints and descriptor bits, and float results within
   tolerance; both routes' per-tile counts must equal the JAX reference's
   (``src/repro_torch/data/reference_counts.json``, written on the CPU by
   ``tests/test_torch_reference_counts.py``: its run without FMA
   contraction, one rounding per operation as the port's; tiles where its
   FMA run differs are printed), and so must each tile's keypoint rows,
   columns, valid flags and BRIEF/ORB packed words and the reduce's top
   fields, held field by field to the file's digests of that run (a SIFT
   tile whose counts differ between its two runs may match either).
   Then the scale-space
   kernel's own path: SIFT over the same scene at tile 256 (961 tiles of
   304^2, the reference's ``launch/extract.py`` defaults), where octave 0
   fuses: the kernel must launch, two runs must be bitwise equal, and the
   run is timed; on all 961 tiles, 64 at a time, the kernel route's
   per-tile counts must equal the reference's Pallas route and the plain
   route's its plain route, a tile where the two port routes differ is
   printed, and where their counts agree the keypoints must too; each
   route's keypoints and valid flags of every tile (and the kernel route's
   whole-run reduce) must match the digests of its reference route.
4. Times each kernel, its twin and a library yardstick where one exists
   (CUDA events around one call, median of 5 after warm-up, and the
   device time per call under ``torch.profiler``), each kernel's bound
   from bytes at 3.35 TB/s and fp32 operations at 67 TFLOP/s: every blur
   shape the main path launches with its launches per scene, and each
   kernel's launch-weighted total over its path; the scale-space launch of
   the tile-256 path (961 octaves of 304^2) by events and under the
   profiler, with its strip width, grid, blocks per SM and its issue floor
   at its own geometry; FAST on the tiles at thresholds 0.15 and 0.08 and
   on uniform noise, each with the share of pixels that pass its compass
   pre-test (counted by torch ops, not by the kernel) and two issue floors
   (the full test on every pixel, the pre-test alone), and the same kernel
   with its pre-test off (m = 0, bitwise as well) on the tiles and on
   noise; a per-stage
   breakdown of
   the scene, and the end-to-end map/reduce with its peak memory, for the
   scene and for a quarter of it (its first 64 tiles).
5. The matching path (``core/matching.py``, ``launch/stitch.py``): holds
   the matcher kernel (one kernel for both of the reference's matcher
   kernels: one segment for its resident one, ``matcher.plan``'s segments
   for its streaming one; below 131,072 rows the one-segment launch must
   equal the planned one bit for bit) against its plain twin: the scene
   pair's shapes (2048 x 2048,
   Hamming W 8, L2 D 128 and 64, 20% invalid rows and SURF-like 80%),
   duplicate rows across the segments' window edges and across neighbouring
   threads' rows, valid rows that all come first (a top-K list), an
   all-equal database (idx must be the first valid row), integer-valued L2
   (exact sums: bitwise), views one element into their buffers (4-byte
   staging), an odd shape, all-invalid databases, nk = 0 and nk below one
   chunk, W = 1, 5 and 16, D = 1, 65 and 128, query tiles that fill the card
   (one segment, no merge), a 1,048,576-row Hamming stream and a 262,144 x
   128 L2 stream (sampled queries against the blocked oracle); two calls on
   two streams in flight at once; and, under ``torch.profiler``, exactly one
   device kernel per call plus one memset where there are segments.  Then
   the measured dispatch (``kernels/dispatch.py``) on a fresh cache file
   under ``build/``: every bucket the path reaches (the shapes of the
   pair's own top-K lists) and six others, each in two contests (the
   kernel's two plans, the measured default on the card, and the torch
   paths), each measuring each candidate once with the kernel launched in
   its probes, a second round from the file measuring nothing,
   ``launch/obs.py --explain-dispatch`` listing every contest, and each
   bucket's four times and both verdicts printed.  Then, with the counters
   at 0 (the path must measure nothing), extracts sift/surf/brief/orb from two overlapping
   7681 x 7831 crops of one scene at a known offset, registers each pair
   through the measured route, the kernels' and the plain route (equal
   matches, offsets within 1e-3, orb within 1 px), and runs the 4-scene
   stitch and its resume; times the matcher beside its twin, its
   one-segment launch, the ``torch_full`` path
   and its bound (by events, on the card under the profiler, and the host
   microseconds of a call), and each of the path's matcher launches on the
   inputs it was given, by events and on the card.
6. Phase 3c, the paper's own experiment on the streaming ingest
   (``data/pipeline.py``, ``launch/scale.py``, ``launch/extract.py``):
   writes the paper scene as one float32 gray band under ``build/``,
   streams it at ``DifetConfig()`` in 4 batches of 64 tiles (bitwise equal
   to ``tile_scene``'s tiles and headers), runs all seven algorithms
   through ``Prefetcher(device_put=True)`` with the counters at 0 (harris,
   fast and blur must launch; per-tile counts equal to phase 3's and to
   the reference file's), times ingest alone, extraction alone (batches
   on the card), the serial loop, the pipelined loop, the prefetcher's
   thread alone and the prefetcher over batches packed in advance (host
   clock, median of 3) with the overlap, and requires under the profiler
   that the staged copies are "Pinned -> Device" on a stream the engine's
   kernels do not use; runs ``run_scaling`` on 3 RGBA band scenes of the
   paper's size (12 batches of 64, workers 1, 2 and 4, harris, fast and
   sift: parity at every worker count, counts above 0); runs
   ``launch/extract.py --stream`` on 3 scenes of 2048^2 at tile 256 with
   ``--fail-after 1`` (exit 2), resumes it (the scale-space kernel must
   launch), builds a plain-route store and holds the two bundle by bundle
   (bundles bitwise, results as phase 3 holds its routes).
7. Phase 3d, the feature service (``serve/``, ``launch/serve.py``) at
   ``ServeConfig()`` (buckets 32, 64, 128, 256 at halo 16, K 128, batch
   8): with the counters at 0, warms up the four algorithm sets (harris;
   harris + shi_tomasi; brief + fast + orb; all seven) into 16 CUDA graphs
   (capture seconds per program, the pool's memory; every program must be
   a graph); per bucket and set serves 8 new tiles in one batch and holds
   each response bitwise to the eager ``extract_features_multi`` of its
   padded tile alone and to the plain route as phase 3 holds its routes
   (harris, fast, blur and scalespace must have launched); serves a 2048^2
   crop of the paper scene as one seven-algorithm request (64 tiles at
   bucket 256), its merged response bitwise equal to ``DifetJob._merge``
   of the direct per-tile results; under ``torch.profiler`` one replay per
   bucket must run harris, fast, blur and scalespace (the launch counters
   tick at capture, not at replay); times a seven-algorithm step eager and
   replayed per bucket (CUDA events); drives a 1,024-request trace (tile
   sizes 32-256, 64 scenes, the four sets) closed-loop at concurrency 16
   with the cache (the repeat pass must be fully cached) and without it
   (the device's busy share over 256 of its requests under the profiler),
   and open-loop (Poisson) at half the uncached rate.  Each service
   uploads, replays and copies back on a CUDA stream of its own.
8. Phase 3e, the replica fleet (``serve/{router,fleet,proc,transport}.py``,
   ``obs/{ship,agg,slo}.py``, ``launch/{fleet,obs}.py``) at ``ServeConfig()``
   on phase 3d's trace, against an oracle ``FeatureService`` on the card
   without cache: 2 process replicas (the telemetry plane on, a shared
   disk tier) take the trace open-loop with a ``kill -9`` of the
   deepest-queued worker after 256 accepted requests: the kill must be
   found through the stale lease, served + shed = injected, every response
   bitwise the oracle's, and each worker's ready marker must show harris,
   fast, blur and scalespace captured into its graphs; a thread fleet of 2
   is forced up to 3 while the trace replays (the third captures its 16
   graphs beside live replays) and drained back to 2, with the counters
   at 0 just before: zero dropped, every response bitwise the oracle's;
   times closed loops without cache at concurrency 16 on 1, 2 and 4
   process replicas (spawn-to-ready seconds and reserved memory per
   worker, the kill to the last re-admitted response); then runs the
   reference's gates ``launch/fleet.py --smoke``, ``--replicas 2 --proc
   --kill-after 16 --smoke``, ``launch/obs.py --smoke`` and ``--fleet
   --smoke`` as subprocesses at once, each of which must exit 0.
9. Phase 3f, the data mesh (``distributed/``, the mesh branches of
   ``core/{engine,job,mosaic}.py``) on the one card listed 4 times and
   3 times (uneven splits): the paper scene (seven algorithms), SIFT at
   tile 256, a ``DifetJob`` of the scene's first 50 tiles and the stitch
   store's ``MatchPhase`` over all 6 pairs, each bit for bit the
   ``mesh=None`` run, with the launch counts per device (counters at 0
   just before each) and the profiler's device index showing every kernel
   of each path on the card; times the scene and tile 256 with the slices
   staged in advance, beside the one-device runs.
10. Phase 3g, the LM substrate's serving path (``models/``,
   ``serve/lm.py``; no kernel of its own): every registered architecture
   at full width in bf16, weights from a seeded generator on the card,
   full depth but for qwen1.5-110b and dbrx-132b (2 layers) and
   deepseek-v3-671b (4: its 3 dense layers and 1 MoE layer of 256
   experts), each freed before the next: ``prefill`` of 4 x 512 tokens
   (+ 256 patches, or 1500 frames), its last logits against ``forward``'s
   (rtol/atol 1e-3); a 16-token teacher-forced ``decode_step`` run against
   ``forward`` at every position within the reference's rtol 0.05 / atol
   0.15 (MoE at no-drop capacity, positions the two runs routed apart
   reported; xlstm-350m and zamba2-2.7b held in a float32 run at full
   width instead, see ``LM_F32_DECODE``); ``greedy_generate`` of 4 x (16 +
   32) twice, bitwise equal; every logit finite; times prefill, a decode
   step with 48 and 512 cache slots (CUDA events) and greedy tokens/s,
   with weight and peak GiB.  Then every arch's ``reduced()`` config in
   float32 with one set of weights on the CPU and the card: logits within
   rtol/atol 1e-4, greedy tokens equal wherever the CPU's top-two gap
   exceeds 1e-3; and smollm-135m at S 4096 (B 1), whose prefill must take
   the online attention in all 30 layers, with ``attention_online`` held
   to ``attention_einsum`` within 2e-3 (float32 inputs) and both timed in
   bf16 beside ``F.scaled_dot_product_attention`` (a yardstick, not on
   the path).  The matmul flags are printed as found.
10b. Phase 3h, the LM substrate's training path (``launch/train.py``,
   ``train/``, ``optim/``, ``checkpoint/``; no kernel of its own), in
   torch's deterministic mode (``CUBLAS_WORKSPACE_CONFIG`` set before the
   first GEMM): smollm-135m through ``launch.train.main`` at its defaults
   (full width and depth, bf16, remat dots, B 8 x S 256, lr 3e-3): 40
   steps uninterrupted, then 20 checkpointed and ``--resume`` to 40, whose
   losses must equal steps 20-39 bit for bit, the mean of the last 10
   losses below the first 10's, every loss and grad norm finite; every
   other arch 2 steps at full width in bf16 with its config's remat, B 4 x
   S 256 (+ 256 patches, or 1500 frames), depth cut only where one card
   cannot hold weights + grads + fp32 m, v (glm4-9b 16 layers,
   qwen1.5-110b and dbrx-132b 1; deepseek-v3-671b only in the reduced
   check: one MoE layer is ~138 GB of such state), loss, grad norm and
   every parameter finite and one changed, with step ms, tokens/s, the
   model-FLOP share, weights + m, v GiB and the peak; smollm-135m's grads
   under remat nothing, dots and full bitwise equal with peaks ordered
   full <= dots <= nothing; its train state checkpointed on the card and
   restored on the CPU bit for bit, and back; one train step of every
   reduced config in float32 on the card against the CPU (loss, grad norm
   and parameters within rtol/atol 1e-4, atol 2 lr where |g| is within
   that of 0).
10b. Phase 3i, the LM substrate's sharding and analysis (no kernel of its
   own): ``launch.dryrun`` on the (16, 16) production mesh for
   smollm-135m train_4k, qwen1.5-110b prefill_32k and deepseek-v3-671b
   decode_32k (subprocesses, a fake process group each), per-card peak
   GiB, FLOPs, collective bytes by kind and roofline terms printed; the
   card's own bf16 GEMM (8192^3) and device-copy (4 GiB) rates beside the
   dry run's H100 constants; smollm-135m through ``launch.train.main`` on
   a one-rank NCCL mesh, 10 steps in deterministic mode, bitwise the
   mesh-less run (losses and checkpoint); and the dry run's (1, 1)
   prediction of that step against the step on the card: local state
   bytes equal, per-card FLOPs of the same counter within 1%, peak GiB
   beside ``max_memory_allocated``.
11. Prints the kernels JSON line (with ``launch_weighted_ms`` and
   ``launch_weighted_bound_ms`` per kernel: the sum over the kernel's
   launches on its path of each one's measured time and its bound, and for
   the extraction kernels ``served_launches_per_replay`` by bucket), a
   ``serve`` line of phase 3d's figures, a ``fleet`` line of phase 3e's,
   a ``mesh`` line of phase 3f's, an ``lm`` line of phase 3g's, a
   ``train`` line of phase 3h's, an ``analysis`` line of phase 3i's, a
   ``dispatch`` line of the dispatch cache's verdicts, the card's
   name and power
   limit, and last ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --mesh-cards N`` runs alone, on a host with N
cards or more (else it exits 2): the build, phase 3f's cases on
``data_mesh(m)`` for m = 1, 2, 4 up to N (each card must launch harris,
fast, blur, scalespace and the matcher), the peak memory a card, Table 1
per card count above 1 (``run_scaling`` over phase 3c's three RGBA
scenes, one worker, beside the one-device sweep, which a mesh of one card
runs; per-batch counts equal; each sweep's prefetcher alone and
extraction alone), then the LM on the cards (``torchrun`` workers of this
script, ``--lm-worker``): smollm-135m at full width, 20 steps on (4, 1)
and (2, 2) against one card (losses within 2e-2, the loss falls, each
rank's local state bytes equal to the dry run's for the same fake mesh,
a checkpoint saved on (4, 1) restored on (2, 2) and on one card bitwise)
and deepseek-v3-671b at full width cut to 4 layers (3 dense + 1 MoE of
256 experts), 2 steps of B 4 x S 256 on (1, 4) with experts over
``model``, and 2 steps of B 32 x S 512 on (2, 2), each rank holding its
own data shard's MoE pairs (finite losses and grad norms; routes and
capacity drops equal one card's on the same MoE input and router; each
rank's local state bytes equal to the dry run's; peak GiB beside the dry
run's), a ``mesh`` and an ``lm_mesh`` JSON line, the cards' names and
power limits, and the last line.

Any failure exits non-zero.  Without CUDA, or outside a checkout, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import collections
import gc
import json
import os
import re
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
# fp32 instructions issued: 128 lanes per clock per SM, 132 SMs, 1.98 GHz
# (an uncontracted multiply or add is one issue, so exact order cannot
# reach the 67 TFLOP/s that counts an FMA as two)
FP32_ISSUES_PER_S = 128 * 132 * 1.98e9
# __popc: 16 per clock per SM at compute capability 9.0 (CUDA C++
# Programming Guide, arithmetic instruction throughput), 132 SMs, at the
# 1.98 GHz boost clock behind the 67 TFLOP/s fp32 figure
POPC_PER_S = 132 * 16 * 1.98e9
CSRC = "src/repro_torch/kernels/csrc"
REFERENCE_COUNTS = ROOT / "src" / "repro_torch" / "data" / "reference_counts.json"
REPLACES = {
    "harris": "src/repro/kernels/harris.py:44",
    "fast": "src/repro/kernels/fastscore.py:20",
    "blur": "src/repro/kernels/blur.py:18",
    "scalespace": "src/repro/kernels/scalespace.py:65",
    # one kernel replaces both of the reference's matcher kernels
    "matcher": "src/repro/kernels/matcher.py:219; "
               "src/repro/kernels/matcher.py:257",
    # the reference selects with reduce_window and top_k, no Pallas kernel
    "select": "none (src/repro/core/nms.py)",
}
SOURCES = {"harris": "harris.cu", "fast": "fastscore.cu", "blur": "blur.cu",
           "scalespace": "scalespace.cu", "matcher": "matcher.cu",
           "select": "select.cu"}
EXTRACT_KERNELS = ("harris", "fast", "blur", "scalespace", "select")
MAIN_KERNELS = ("harris", "fast", "blur", "select")   # the tile-512 path's
MATCH_KERNELS = ("matcher",)
# the matching path's descriptors: (metric, words or dimensions)
MATCH_WIDTHS = {"sift": ("l2", 128), "surf": ("l2", 64),
                "brief": ("hamming", 8), "orb": ("hamming", 8)}
# buckets the dispatch step also measures beside the path's, with the
# kernel's plans and with the torch paths: (metric, width, queries, rows),
# smaller and larger databases
DISPATCH_EXTRA = (("hamming", 8, 128, 128), ("l2", 128, 128, 128),
                  ("hamming", 8, 512, 512), ("l2", 128, 512, 512),
                  ("hamming", 8, 2048, 16384), ("l2", 128, 2048, 16384))
PAIR_OFFSET = (16, 1958)   # scene b's origin in scene a, full-size pair
STITCH_FAST_THRESHOLD = 0.08   # launch/stitch.py's FAST threshold
STITCH_ARGS = ["--scenes", "4", "--scene-size", "2048", "--overlap", "512",
               "--tile", "512", "--max-keypoints", "512", "--algorithm",
               "orb"]
BATCH_TILES = 64           # tiles a streamed batch (80.3 MB at tile 512)
SWEEP_ALGORITHMS = ("harris", "fast", "sift")   # launch/scale.py's default
SWEEP_WORKERS = (1, 2, 4)
DRIVER_ALGORITHMS = ("harris", "shi_tomasi", "sift", "surf", "fast", "brief",
                     "orb")
DRIVER_ARGS = ["--stream", "--scenes", "3", "--scene-size", "2048",
               "--algorithms", ",".join(DRIVER_ALGORITHMS)]
# phase 3d, the feature service at ServeConfig(): the four algorithm sets
# warmed up (16 programs at 4 buckets), the load trace, the oversize chip
SERVE_SETS = (("harris",), ("harris", "shi_tomasi"), ("brief", "fast", "orb"),
              DRIVER_ALGORITHMS)
SERVE_REQUESTS = 1024
SERVE_SCENES = 64
SERVE_CONCURRENCY = 16
SERVE_OVERSIZE = 2048      # a 2048^2 crop of the paper scene: 64 tiles of 256
SERVE_BUSY_REQUESTS = 256  # the closed loop without cache under the profiler
# phase 3e, the replica fleet at ServeConfig(): the kill -9 (and the thread
# fleet's scale-up) after this many accepted requests of phase 3d's trace
FLEET_KILL_AFTER = 256
FLEET_REPLICA_COUNTS = (1, 2, 4)     # process replicas of the closed loop
FLEET_SMOKES = (                     # the reference's own gates
    ("-m", "repro_torch.launch.fleet", "--smoke"),
    ("-m", "repro_torch.launch.fleet", "--replicas", "2", "--proc",
     "--kill-after", "16", "--smoke"),
    ("-m", "repro_torch.launch.obs", "--smoke"),
    ("-m", "repro_torch.launch.obs", "--fleet", "--smoke"),
)
# phase 3f, the data mesh: the one card listed this many times, and the
# job's bundle (the scene's first tiles: 4 shards of 13, 13, 12, 12)
MESH_REPEAT = 4
MESH_JOB_TILES = 50
# phase 3g, the LM substrate's serving path: every registered arch at full
# width in bf16; depth cut only where one card cannot hold the model, to
# the fewest layers that keep every kind of block
LM_DEPTH_CUTS = {"qwen1.5-110b": 2, "dbrx-132b": 2,
                 "deepseek-v3-671b": 4}      # 3 dense layers + 1 MoE layer
LM_BATCH, LM_PROMPT = 4, 512        # prefill B x S (+ patches / frames)
LM_TEACHER = 16                     # teacher-forced decode steps
LM_GREEDY = (16, 32)                # greedy prompt, new tokens
LM_CACHE_SLOTS = (48, 512)          # init_cache sizes of the decode timing
LM_DECODE_TOL = dict(rtol=0.05, atol=0.15)   # the reference's decode gate
LM_EXACT_TOL = dict(rtol=1e-4, atol=1e-4)    # card against CPU, float32
LM_TIE_GAP = 1e-3                   # greedy tokens held above this gap
# the recurrent archs' decode and forward forms round apart, as the
# reference's do (its Mamba2 decode convolves in float32 where the forward
# does in bf16, src/repro/models/ssm.py:134,153; its mLSTM decode keeps the
# conv window in bf16 even in float32, :300,335), and the rounding grows
# over 24-54 layers: at full width in bf16 their decode misses
# LM_DECODE_TOL, so the bf16 difference is printed and the leading
# positions given here are held in a float32 run at full width instead:
# Zamba's all; xLSTM's first (from the second token its window is bf16)
LM_F32_DECODE = {"xlstm-350m": 1, "zamba2-2.7b": LM_TEACHER}
LM_LONG = ("smollm-135m", 4096)     # = ONLINE_ATTN_MIN_SEQ, B 1
# phase 3h, the LM substrate's training path: smollm-135m through
# launch/train.py at its defaults (B 8 x S 256, lr 3e-3, warm-up 20, the
# config's remat), uninterrupted and checkpointed then resumed; every other
# arch 2 steps at full width in bf16, depth cut only where one card cannot
# hold weights + grads + fp32 m, v (12 bytes a parameter); deepseek-v3's
# one MoE layer of 256 experts alone needs ~138 GB of that state, so it
# trains in the reduced check only
TRAIN_MAIN = ["--arch", "smollm-135m", "--log-every", "10"]
TRAIN_STEPS, TRAIN_RESUME_AT = 40, 20
TRAIN_DEPTH_CUTS = {"glm4-9b": 16, "qwen1.5-110b": 1, "dbrx-132b": 1}
TRAIN_SKIP_FULL = ("deepseek-v3-671b",)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_ARCH_STEPS = 4, 256, 2
TRAIN_F32_TOL = dict(rtol=1e-4, atol=1e-4)   # card against CPU, float32
TRAIN_F32_LR = 1e-3
BF16_PEAK_FLOPS = 989e12            # H100 SXM dense bf16, data sheet
# phase 3i, the LM substrate's sharding and analysis: launch.dryrun on the
# (16, 16) production mesh for these cells (subprocesses: a process holds
# one process group), the card's own rates beside the H100 constants,
# smollm-135m through launch.train on a one-rank NCCL mesh (bitwise the
# mesh-less run) and the dry run's (1, 1) prediction of that step
DRYRUN_CELLS = (("smollm-135m", "train_4k"), ("qwen1.5-110b", "prefill_32k"),
                ("deepseek-v3-671b", "decode_32k"))
DRYRUN_TIMEOUT = 600
MESH_TRAIN_STEPS = 10
LAUNCH_B, LAUNCH_S = 8, 256        # launch/train.py's default batch
# --mesh-cards: the LM on a mesh of cards (torchrun workers of this
# script): smollm-135m at full width on (4, 1) and (2, 2), against one
# card; deepseek-v3-671b at full width cut to 4 layers (3 dense + 1 MoE of
# 256 experts) on (1, 4), experts over ``model`` (~15.1 B parameters: 169
# GiB of weights, grads and fp32 m, v, which no one card holds), and on
# (2, 2), its MoE's pairs split over ``data``, at a B x S whose global
# [T*k, d] pairs (what a rank held before they were split) take 1.75 GiB
LM_MESH_STEPS, LM_MESH_TOL, LM_MESH_LR, LM_MESH_WARMUP = 20, 2e-2, 3e-3, 5
DSV3_LAYERS, DSV3_STEPS = 4, 2
DSV3_BATCH = {(1, 4): (4, 256), (2, 2): (32, 512)}     # mesh: (B, S)
DSV3_PREFILL = ((2, 2), 16, 512)   # mesh, B (8 chunks of 2 rows), S
# smollm's largest loss gap to one card that this script measured on 4 x
# NVIDIA H100 80GB HBM3 (700 W) before sharded products rounded once
SMOLLM_GAPS_BEFORE = {"4x1": 1.155e-3, "2x2": 3.306e-3}
# device kernel names of each wrapper's kernels (the profiler's keys)
DEVICE_NAMES = {"harris": ("harris_kernel",), "fast": ("fast_tiled",),
                "blur": ("blur_tiled", "blur_small"),
                "scalespace": ("scalespace_strip",),
                "matcher": ("match_kernel",), "select": ("difet_select",)}


def ptxas_entries(text):
    """(kernel, registers, static shared bytes, spills) of each entry
    function in an ``nvcc --ptxas-options=-v`` report; a template kernel
    reads as ``name<R>``."""
    out, entry, spill, smem = [], None, "", 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry, spill, smem = kernel_label(m.group(1)), "", 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"{m.group(1)} B stores, {m.group(2)} B loads"
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            s = re.search(r"(\d+) bytes smem", line)
            smem = int(s.group(1)) if s else 0
            out.append((entry, int(m.group(1)), smem, spill))
            entry = None
    return out


def kernel_label(mangled):
    """``name<R>`` for an Itanium-mangled template kernel ``...<int R>``,
    else the mangled name's tail."""
    for m in re.finditer(r"\d+", mangled):
        n = int(m.group(0))
        name, rest = mangled[m.end():m.end() + n], mangled[m.end() + n:]
        t = re.match(r"ILi(\d+)E", rest)
        if name.isidentifier() and t:
            return f"{name}<{t.group(1)}>"
    # a plain kernel: the last <length><name> of its (nested) name
    i, names = (3 if mangled.startswith("_ZN") else 2), []
    while (d := re.match(r"\d+", mangled[i:])) is not None:
        j = i + d.end()
        names.append(mangled[j:j + int(d.group(0))])
        i = j + int(d.group(0))
    names = [n for n in names if not n.startswith("_GLOBAL")]
    return names[-1] if names else mangled[-28:]


# every log line is also written here (a git-ignored directory), for a
# caller that keeps only the end of the standard output
LOG_FILE = ROOT / "chiprun_out" / "chip_smoke.log"
_log_file = []


def log(*args):
    print(*args, flush=True)
    if _log_file:
        print(*args, file=_log_file[0], flush=True)


def require(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def fresh_dispatch_cache(name):
    """Point the matcher dispatch's cache (`kernels/dispatch.py`) at a new
    file ``build/<name>`` of the checkout, and return its path: every
    verdict of the run is measured on this card and stays in the checkout."""
    path = ROOT / "build" / name
    path.parent.mkdir(exist_ok=True)
    path.unlink(missing_ok=True)
    os.environ["DIFET_TORCH_DISPATCH_CACHE"] = str(path)
    return path


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


def fast_ops(arc):
    """(pre-test, full test) operations an output.  The compass pre-test:
    centre + t and centre - t, 8 compares, 8 to pack the two 4-bit flag
    sets, 4 to look them up.  The full test: per ring pixel 2 compares,
    v - c, its absolute value, - t and two masked adds (16 x 7), 32 to pack
    the two 16-bit flag masks, each mask's arc test (double it, arc - 1
    shift-ANDs, mask and test: 2 (arc - 1) + 3), their or, the max and the
    select."""
    return 2 + 8 + 8 + 4, 16 * 7 + 32 + 2 * (2 * (arc - 1) + 3) + 3


def fast_work(n, h, w, arc, survivors):
    """The pre-test on every output and the full test on the ``survivors``
    that pass it (the data's own need: the others are exactly 0)."""
    pre, full = fast_ops(arc)
    return n * h * w * pre + survivors * full, n * h * w * 8


def compass_survivors(torch, x, t, arc):
    """Pixels of ``x`` that pass FAST's compass pre-test at threshold t:
    the compass points (ring indices 0, 4, 8, 12) hold a circular run of
    ``arc // 4`` brighter or darker ones.  Plain torch ops on the card."""
    from repro_torch.core.padding import reflect_pad
    from repro_torch.core.pyramid import f32
    m, t = arc // 4, f32(t)
    if m == 0:
        return x.numel()
    h, w = x.shape[-2:]
    xp = reflect_pad(x, 3)
    c = xp[..., 3:3 + h, 3:3 + w]
    pts = [xp[..., 3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
           for dy, dx in ((-3, 0), (0, 3), (3, 0), (0, -3))]

    def run(flags):
        hit = None
        for s0 in range(4):
            r = flags[s0]
            for j in range(1, m):
                r = r & flags[(s0 + j) % 4]
            hit = r if hit is None else hit | r
        return hit

    hi, lo = c + t, c - t
    return int((run([p > hi for p in pts]) | run([p < lo for p in pts]))
               .sum())


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


def scalespace_issue_ops(n, h, w, radii, wt):
    """fp32 instructions of the strip kernel's blur and DoG at its own
    geometry, in exact order (a tap is a multiply and an add: 4r + 1 an
    output of a pass): every strip computes level s over wt + 2 m_s columns,
    its W pass over the rows of level s - 1 and its H pass over its own."""
    m = [sum(radii) + 1]
    for r in radii:
        m.append(m[-1] - r)
    ops = 0
    for s, r in enumerate(radii, start=1):
        cols = wt + 2 * m[s]
        ops += cols * (h + 2 * m[s - 1] + h + 2 * m[s]) * (4 * r + 1)
        ops += (wt + 2) * (h + 2)                         # DoG
    return n * -(-w // wt) * ops


def bound(work):
    ops, nbytes = work
    t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def match_work(nq, nk_valid, nk, width, metric):
    """(operations, bytes) of one match: every (query, valid row) pair; a
    Hamming pair is ``width`` popcounts, an L2 pair ``width`` FMAs (2
    operations), plus |k|^2 and |q|^2; inputs read once, the triple
    written once."""
    nbytes = (nq + nk) * width * 4 + nk * 4 + nq * 12
    if metric == "hamming":
        return nq * nk_valid * width, nbytes
    return 2 * width * (nq * nk_valid + nk + nq), nbytes


def match_bound(work, metric):
    ops_, nbytes = work
    t_ops = ops_ / (POPC_PER_S if metric == "hamming" else FP32_OPS_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def check_matcher(torch, np, dev):
    """The matcher kernel against its plain twin on the card; returns the
    largest |kernel - twin| of a best distance.  Below FULL_MAX_ROWS rows
    the one-segment launch (``cuda_resident``) must equal the planned one
    (``cuda_stream``) bit for bit, and the twin as the planned one does."""
    from repro_torch.kernels import matcher as M
    from repro_torch.kernels import ref
    rng = np.random.RandomState(1)
    index = torch.cuda.current_device()

    def make(metric, n, width, integer=False):
        if metric == "hamming":
            a = rng.randint(0, 2 ** 32, (n, width), dtype=np.uint64) \
                .astype(np.uint32).view(np.int32)
        elif integer:                  # every sum exact: ties are exact too
            a = rng.randint(-3, 4, (n, width)).astype(np.float32)
        else:
            a = rng.randn(n, width).astype(np.float32)
        return torch.from_numpy(a).to(dev)

    def valid(n, frac):
        return torch.from_numpy((rng.rand(n) >= frac).astype(np.int32)).to(dev)

    def plan(metric, nq, nk, width):
        return M.plan(nq, nk, M.slots(index, metric, width))

    def hold(tag, metric, got, want, name, bitwise=False):
        torch.cuda.synchronize()
        if metric == "hamming" or bitwise:
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            require(same, f"{tag}: {name} is not bitwise equal to its twin")
            return 0.0, 0
        ok = all(torch.allclose(a, b, rtol=1e-5, atol=1e-4)
                 for a, b in zip(got[:2], want[:2]))
        require(ok, f"{tag}: {name} best/second beyond rtol 1e-5 atol 1e-4")
        gap = (want[1] - want[0]) > 1e-4 + 1e-5 * want[1].abs()
        require(bool((got[2] == want[2])[gap].all()),
                f"{tag}: {name} idx differs where best and second are apart")
        near = int(((got[2] != want[2]) & ~gap).sum())
        fin = torch.isfinite(want[0])
        e = (got[0] - want[0])[fin].abs().max().item() if bool(fin.any()) \
            else 0.0
        return e, near

    log("matcher kernel vs its plain twin best2_scan on the card (Hamming "
        "bitwise, L2 rtol 1e-5 atol 1e-4 with idx equal where best and second "
        "are apart, integer-valued L2 bitwise):")
    for metric, width in (("hamming", 8), ("hamming", 16), ("l2", 64),
                          ("l2", 128)):
        log(f"  {metric} width {width}: {M.slots(index, metric, width)} "
            f"blocks at once on the card")
    err = 0.0
    # query tiles that fill the card: one segment, no merge
    fill_h = M.slots(index, "hamming", 8) * M.QBLOCK
    fill_l = M.slots(index, "l2", 128) * M.QBLOCK
    # (metric, width, queries, rows, invalid share, data): "ties" duplicates
    # rows across the segments' window edges and across neighbouring threads'
    # rows, "first" makes the first 413 rows the valid ones (SURF's top-K
    # list on the matching path), "equal" makes every row the same, "int"
    # integer-valued L2 (exact sums, ties exact), "view" a view one element
    # into its buffer (4-byte staging)
    cases = [("hamming", 8, 2048, 2048, 0.2, "ties"),
             ("l2", 128, 2048, 2048, 0.2, "ties"),
             ("l2", 64, 2048, 2048, 0.2, "ties"),
             ("l2", 64, 2048, 2048, 0.8, "ties"),      # SURF-like, 20% valid
             ("hamming", 8, 2048, 2048, 0.8, "ties"),
             ("l2", 64, 2048, 2048, 0.0, "first"),      # a top-K list
             ("hamming", 8, 2048, 2048, 0.0, "first"),
             ("l2", 128, 2048, 2048, 0.2, "int"),
             ("l2", 64, 2048, 2048, 0.8, "int"),
             ("hamming", 8, 2048, 2048, 0.2, "equal"),
             ("l2", 128, 2048, 2048, 0.2, "equal"),
             ("hamming", 8, 1000, 3000, 0.2, "view"),
             ("l2", 128, 1000, 3000, 0.2, "view"),
             ("hamming", 8, 300, 1000, 0.2, "ties"),
             ("l2", 128, 300, 1000, 0.2, "ties"),
             ("hamming", 8, 64, 3000, 1.0, "ties"),     # all invalid
             ("l2", 64, 64, 3000, 1.0, "ties"),
             ("hamming", 8, 300, 50, 0.2, "ties"),      # less than a chunk
             ("l2", 128, 300, 50, 0.2, "ties"),
             ("hamming", 8, 300, 0, 0.0, "ties"),       # no rows at all
             ("l2", 64, 300, 0, 0.0, "ties"),
             ("hamming", 1, 500, 3000, 0.2, "ties"),
             ("hamming", 16, 500, 3000, 0.2, "ties"),
             ("hamming", 5, 500, 3000, 0.2, "ties"),
             ("l2", 1, 500, 3000, 0.2, "int"),
             ("l2", 65, 500, 3000, 0.2, "ties"),
             ("l2", 65, 500, 3000, 0.2, "int"),
             ("l2", 128, 500, 3000, 0.2, "int"),
             ("hamming", 8, fill_h, 300, 0.2, "ties"),
             ("l2", 128, fill_l, 300, 0.2, "ties")]
    singles = 0
    for metric, width, nq, nk, frac, data in cases:
        q = make(metric, nq, width, data == "int")
        db = make(metric, nk, width, data == "int")
        v = valid(nk, frac)
        if data == "first":
            v = (torch.arange(nk, device=dev) < 413).to(torch.int32)
        n_seg = plan(metric, nq, nk, width)
        if data == "ties" and nk > 1:
            for c in range(M.WINDOW, nk, M.WINDOW):      # across the segments
                db[c] = db[c - 1]
            db[1::7] = db[0::7][:db[1::7].shape[0]]      # neighbouring rows
        if data == "equal":
            db[:] = db[nk // 3]
        if data == "view":
            buf_q = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)
            buf_d = torch.empty(db.numel() + 1, dtype=db.dtype, device=dev)
            q = buf_q[1:].view(q.shape).copy_(q)
            db = buf_d[1:].view(db.shape).copy_(db)
            require(q.data_ptr() % 16 == 4 and db.data_ptr() % 16 == 4,
                    "the views must be 4 bytes off 16")
        singles += n_seg == 1
        tag = (f"{metric} W/D {width} {nq}x{nk} invalid {frac:.0%} {data}")
        r = M.match(q, db, v, metric=metric)
        twin = M.best2_scan(q, db, v, metric=metric)
        e1, n1 = hold(tag, metric, r, twin, "kernel", bitwise=data == "int")
        one = M.launch(q, db, v, metric=metric, segments=1)
        hold(tag, metric, one, r, "the one-segment launch (against the "
             "planned one)", bitwise=True)
        hold(tag, metric, one, twin, "the one-segment launch",
             bitwise=data == "int")
        if frac == 1.0 or nk == 0:
            big = M.big_for(metric)
            require(bool((r[0] == big).all() & (r[1] == big).all()
                         & (r[2] == 0).all()),
                    f"{tag}: an all-invalid database must give BIG, BIG, 0")
        if data == "equal":
            first = int(torch.nonzero(v)[0])
            require(bool((r[2] == first).all() & (r[0] == r[1]).all()),
                    f"{tag}: an all-equal database must give the first valid "
                    f"row {first} and second == best")
        if metric == "hamming" and 0 < nq * nk <= 2048 * 2048:
            o = ref.match_best2(q, db, v, metric=metric)
            require(all(torch.equal(a, b) for a, b in zip(r, o)),
                    f"{tag}: kernel differs from the unpacked-bit oracle")
        err = max(err, e1)
        log(f"  {tag:52s} {n_seg:4d} segment(s); equal to the twin; "
            f"max|err| {e1:.3g}; idx differing at near-ties {n1}; one "
            f"segment bitwise the plan")
    require(singles >= 4, "the single-segment form was not exercised")

    # two calls on two streams in flight at once: no shared state
    q, db = make("hamming", 2048, 8), make("hamming", 1 << 16, 8)
    v = valid(1 << 16, 0.2)
    want = M.best2_scan(q, db, v, metric="hamming")
    hold("2048x65536x8", "hamming", M.launch(q, db, v, metric="hamming",
                                             segments=1), want,
         "the one-segment launch")
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    torch.cuda.synchronize()
    for _ in range(10):
        outs = []
        for st in streams:
            with torch.cuda.stream(st):
                outs.append(M.match(q, db, v, metric="hamming"))
        torch.cuda.synchronize()
        for o in outs:
            hold("two streams", "hamming", o, want, "kernel")
    log(f"  two streams, 10 rounds of two concurrent calls at 2048x65536x8 "
        f"({plan('hamming', 2048, 1 << 16, 8)} segments): every triple "
        f"equal to the twin, as is the one-segment launch's")

    # one device kernel per call, and at most one memset
    for metric, width, nq, nk in (("hamming", 8, 2048, 2048),
                                  ("l2", 128, 2048, 2048),
                                  ("hamming", 8, fill_h, 300)):
        q, db, v = make(metric, nq, width), make(metric, nk, width), \
            valid(nk, 0.2)
        n_seg = plan(metric, nq, nk, width)
        want_memsets = 10 if n_seg > 1 else 0
        # the profiler can drop an activity (it may record 9 kernels for
        # 10 calls): a session that recorded fewer, and nothing else, is
        # run again, up to 3 times; one that recorded more or anything
        # else fails at once
        for _ in range(3):
            dev_ev = {k: c for k, (c, _) in device_events(
                torch, lambda: M.match(q, db, v, metric=metric), 10).items()}
            kernels = sum(c for k, c in dev_ev.items()
                          if "match_kernel" in k)
            memsets = sum(c for k, c in dev_ev.items()
                          if k.lower().startswith("memset"))
            only = sum(dev_ev.values()) == kernels + memsets
            if not (only and kernels <= 10 and memsets <= want_memsets) \
                    or (kernels == 10 and memsets == want_memsets):
                break
        require(kernels == 10 and only and memsets == want_memsets,
                f"{metric} {nq}x{nk}: 10 calls ran {dev_ev} on the card, "
                f"not one kernel each and one memset each with segments")
        log(f"  profiler, 10 calls of {metric} {nq}x{nk}x{width} ({n_seg} "
            f"segments): {kernels} kernels, {memsets} memsets, nothing else")

    streams = [("hamming", 8, 2048, 1 << 20, 0.05),
               ("l2", 128, 2048, 1 << 18, 0.05)]
    for metric, width, nq, nk, frac in streams:
        q, db, v = make(metric, nq, width), make(metric, nk, width), \
            valid(nk, frac)
        tag = f"stream {metric} {nq}x{nk}x{width} invalid {frac:.0%}"
        t0 = time.perf_counter()
        st = M.match(q, db, v, metric=metric)
        e1, _ = hold(tag, metric, st, M.best2_scan(q, db, v, metric=metric),
                     "kernel")
        sample = torch.from_numpy(rng.choice(nq, 64, replace=False)).to(dev)
        o = ref.match_best2_blocked(q[sample], db, v, metric=metric)
        e3, _ = hold(tag, metric, tuple(x[sample] for x in st), o,
                     "kernel (64 sampled queries vs the blocked oracle)")
        err = max(err, e1, e3)
        log(f"  {tag:52s} {plan(metric, nq, nk, width):4d} segments; "
            f"equal to the twin and to the blocked oracle on 64 sampled "
            f"queries; max|err| {max(e1, e3):.3g} "
            f"({time.perf_counter() - t0:.1f} s)")
    return err


def select_phase(torch, np, dev, cells):
    """The selection kernel (``ops.select_keypoints``, csrc/select.cu)
    against its twin (``core/nms.py::select_keypoints`` run on the card),
    every field bit for bit and dtype for dtype, and each shape run twice
    (identical): every algorithm's map at each cell's shape (``cells``:
    (label, cfg, tiles, headers)); a serving bucket's shape (8 tiles of
    288^2, halo 16, K 128) captured in a CUDA graph and replayed on two
    inputs; K 1 and K = H W on small tiles (a padding tile, extents 1, 5
    and 17) at thresholds 0, 0.25 and -0.3 over plateaus; the scratch
    sort (more than 4096 keys) with and without the radix select; a side
    stream, as a mesh entry's.  Times each algorithm's call at the cells'
    shapes: kernel ms by events [device ms under the profiler], its least
    time (bytes, ``portbench/work/select.py``), the twin's ms.  Returns
    ({cell label: [row]}, the paper cell's launch-weighted (ms, bound))."""
    from portbench.work.select import work as select_work
    from repro_torch.core import engine, nms
    from repro_torch.kernels import ops
    fields = ("count", "ys", "xs", "scores", "valid")

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    def held(resp, headers, what, **kw):
        got = ops.select_keypoints(resp, headers, **kw)
        again = ops.select_keypoints(resp, headers, **kw)
        want = nms.select_keypoints(resp, headers, **kw)
        torch.cuda.synchronize()
        for name, a, b, c in zip(fields, got, want, again):
            require(a.dtype == b.dtype and a.shape == b.shape
                    and torch.equal(bits(a), bits(b)),
                    f"select {what}: {name} differs from the twin")
            require(torch.equal(bits(a), bits(c)),
                    f"select {what}: two runs differ in {name}")
        log(f"  select {what:52s} {str(tuple(resp.shape)):16s} k {kw['k']:5d}"
            f" thr {kw['threshold']:+.4g}: bitwise, {int(got[0].sum())} "
            f"counted, {int(got[4].sum())} valid slots")
        return got

    log("selection kernel against its twin on the card (bitwise, every "
        "field):")
    rows, paper_total = {}, (0.0, 0.0)
    for label, cfg, tiles, headers in cells:
        maps, rows[label] = {}, []
        for alg, spec in engine.ALGORITHMS.items():
            if spec.response not in maps:
                maps[spec.response] = spec.response(tiles, cfg, True)
            resp = maps[spec.response]
            kw = dict(k=cfg.max_keypoints_per_tile,
                      threshold=float(np.float32(spec.threshold(cfg))),
                      halo=cfg.halo)
            held(resp, headers, f"{label} {alg}", **kw)
            run = lambda: ops.select_keypoints(resp, headers, **kw)
            row = dict(algorithm=alg, shape=list(resp.shape), ms=cuda_ms(run),
                       device_ms=device_us_per_call(torch, run, 10) / 1e3,
                       plain_ms=cuda_ms(
                           lambda: nms.select_keypoints(resp, headers, **kw)),
                       launches=1)
            row["bound_ms"], row["bound_by"] = bound(
                select_work(tuple(resp.shape), headers, **kw))
            log(f"    {label} {alg:10s} kernel {row['ms']:.4f} ms "
                f"[{row['device_ms']:.4f}]  least {row['bound_ms']:.4f} ms "
                f"({row['bound_by']})  plain {row['plain_ms']:.4f} ms  "
                f"launches per scene 1")
            rows[label].append(row)
        del maps
    paper = rows[cells[0][0]]
    paper_total = (sum(r["ms"] for r in paper),
                   sum(r["bound_ms"] for r in paper))

    # a serving bucket under graph capture: static inputs, replayed twice
    cfg_b = cells[1][1]
    b_tiles = cells[1][2][:8, 8:296, 8:296].contiguous()
    b_hdr = cells[1][3][:8].clone()
    b_hdr[:, 3:5] = 256
    b_hdr[5, 3], b_hdr[5, 4] = 1, 151
    kw = dict(k=128, threshold=float(np.float32(
        engine.ALGORITHMS["harris"].threshold(cfg_b))), halo=16)
    harris = engine.ALGORITHMS["harris"].response
    maps = [harris(t, cfg_b, True) for t in (b_tiles, b_tiles.flip(-1))]
    static = maps[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.select_keypoints(static, b_hdr, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.select_keypoints(static, b_hdr, **kw)
    for i, m in enumerate(maps):
        static.copy_(m)
        graph.replay()
        want = nms.select_keypoints(m, b_hdr, **kw)
        torch.cuda.synchronize()
        for name, a, b in zip(fields, out, want):
            require(torch.equal(bits(a), bits(b)),
                    f"select under graph replay {i}: {name} differs")
    log(f"  select captured in a CUDA graph at {tuple(static.shape)}, k 128,"
        f" two replays on two maps: bitwise the twin")

    # small tiles: K 1 and K = H W, plateaus, a padding tile, edge extents
    gen = torch.Generator(device=dev).manual_seed(3)
    q = torch.randint(0, 4, (6, 40, 40), generator=gen, device=dev) / 4.0
    hdr = torch.tensor([[0, 0, 0, 32, 32, 0], [0, 0, 1, 1, 32, 0],
                        [0, 1, 0, 32, 1, 0], [0, 1, 1, 32, 32, 1],
                        [0, 2, 0, 17, 5, 0], [0, 2, 1, 32, 32, 0]],
                       dtype=torch.int32, device=dev)
    for k in (1, 40 * 40):
        for m, thr in ((q, 0.0), (q, 0.25), (q - 0.5, -0.3)):
            held(m.contiguous(), hdr,
                 "small tiles, plateaus", k=k, threshold=thr, halo=4)
    # more than 4096 keys: the scratch sort, with and without the select
    big = (torch.randint(0, 64, (2, 80, 80), generator=gen, device=dev)
           / 64.0 - 0.5)
    hdr2 = torch.tensor([[0, 0, 0, 72, 72, 0], [0, 0, 1, 70, 33, 0]],
                        dtype=torch.int32, device=dev)
    for k, thr in ((6400, -1.0), (4500, -1.0), (6400, 0.0), (300, -1.0)):
        held(big, hdr2, "80^2, scratch sort", k=k, threshold=thr, halo=4)
    # a side stream, as a mesh entry issues its work
    resp = harris(cells[0][2][:16], cells[0][1], True)
    kw = dict(k=512, threshold=float(np.float32(
        engine.ALGORITHMS["harris"].threshold(cells[0][1]))), halo=24)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = ops.select_keypoints(resp, cells[0][3][:16], **kw)
    side.synchronize()
    want = nms.select_keypoints(resp, cells[0][3][:16], **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(fields, got, want):
        require(torch.equal(bits(a), bits(b)),
                f"select on a side stream: {name} differs")
    log("  select on a side stream (a mesh entry's): bitwise the twin")
    log("select_rows " + json.dumps(rows))
    return rows, paper_total


def host_us_per_call(torch, fn, n=200):
    """Median host microseconds of one call of ``fn``: the time until it
    returns, with the card's work only queued."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def device_events(torch, fn, n, tries=3):
    """{device activity: (count, device us)} of ``n`` calls of ``fn`` under
    ``torch.profiler``.  A session that recorded no device activity at all
    (the profiler drops one now and then) is run again, up to ``tries``
    times; an empty result after that means the profiler sees no card."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        out = {ev.key: (ev.count, ev.self_device_time_total)
               for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA}
        if out:
            return out
    return {}


def device_us_per_call(torch, fn, n):
    """Device microseconds per call of ``fn``: the CUDA kernels' own time
    under ``torch.profiler`` over ``n`` calls (the event timings include
    the wrapper's host work when it outlasts the kernels)."""
    return sum(us for _, us in device_events(torch, fn, n).values()) / n


def device_activity(torch, fn, tries=3):
    """[(name, stream)] of every device activity (kernels, copies) of one
    ``fn()`` under ``torch.profiler``; the stream is the profiler's id of
    the CUDA stream it ran on.  A session that recorded nothing is run
    again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = [(ev.name, ev.device_resource_id) for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
        if out:
            return out
    return []


def against_reference(tag, per_tile, modes):
    """The port's per-tile counts against the reference's: equal on every
    tile to its run without FMA ("no_fma", one rounding per operation, as
    the port computes); a tile where they differ from its run as XLA builds
    it for an FMA CPU ("fma", multiply-adds contracted) is printed, and
    must be one where the reference's two runs differ."""
    exact, fma = modes["no_fma"]["per_tile"], modes["fma"]["per_tile"]
    require(len(per_tile) == len(exact), f"{tag}: {len(per_tile)} tiles, "
            f"the reference has {len(exact)}")
    bad = [(i, a, b) for i, (a, b) in enumerate(zip(per_tile, exact))
           if a != b]
    require(not bad, f"{tag}: per-tile counts differ from the reference's "
            f"(tile, port, reference): {bad[:20]}")
    moved = [(i, a, fma[i]) for i, a in enumerate(per_tile) if a != fma[i]]
    require(all(exact[i] != fma[i] for i, _, _ in moved),
            f"{tag}: differs from the reference's FMA run where its two "
            f"runs agree")
    log(f"  {tag}: per-tile counts equal the reference's (no FMA) on all "
        f"{len(per_tile)} tiles (total {sum(per_tile)}); its FMA run "
        f"differs at {len(moved)} tile(s) (tile, port, FMA run): {moved}")


def against_digests(tag, alg, per_tile, modes, result=None):
    """The port's exact fields against the reference's digests
    (``reference_counts.json``): each tile's ``ys``, ``xs``, ``valid``
    (and BRIEF's and ORB's packed words) of the map's output ``per_tile``,
    and the reduce's top fields of ``result``, equal to the reference's run
    without FMA ("no_fma").  A SIFT tile where the reference's two runs
    count differently may match its FMA run instead (and the reduce then
    too); any other difference fails, naming the tile and the field."""
    from repro_torch.data import digests as DG
    exact, fma = modes["no_fma"], modes["fma"]
    either = set()
    if alg == "sift":
        either = {i for i, (a, b) in enumerate(zip(exact["per_tile"],
                                                    fma["per_tile"]))
                  if a != b}
    got = DG.tile_digests({f: per_tile[f].cpu() for f in DG.fields(alg)},
                          alg)
    bad, as_fma = [], []
    for field, tiles in got.items():
        require(len(tiles) == len(exact["digests"][field]),
                f"{tag}: {len(tiles)} tiles, the reference has "
                f"{len(exact['digests'][field])}")
        for i, d in enumerate(tiles):
            if d == exact["digests"][field][i]:
                continue
            if i in either and d == fma["digests"][field][i]:
                as_fma.append((i, field))
            else:
                bad.append((i, field))
    require(not bad, f"{tag}: fields differ from the reference's (no FMA) "
            f"at (tile, field): {bad[:20]}")
    line = (f"  {tag}: {', '.join(got)} of all {len(got['ys'])} tiles equal "
            f"the reference's (no FMA)")
    if result is not None:
        top = DG.top_digests({k: v.cpu() for k, v in result.items()}, alg)
        allowed = [exact["top"]] + ([fma["top"]] if as_fma else [])
        top_bad = [f for f in top if all(top[f] != t[f] for t in allowed)]
        require(not top_bad, f"{tag}: the reduce's {top_bad} differ from "
                f"the reference's")
        line += f", and so do the reduce's {', '.join(DG.TOP[f] for f in top)}"
    log(line + (f"; as its FMA run at (tile, field) {as_fma}" if as_fma
                else ""))


def register_all(torch, matching, feats, algs, use_kernels):
    """register_pair (translation) for each algorithm on scene a -> b."""
    out = {}
    for alg in algs:
        fa, fb = feats[0][alg], feats[1][alg]
        out[alg] = matching.register_pair(
            fa["top_ys"], fa["top_xs"], fa["top_desc"], fa["top_valid"],
            fb["top_ys"], fb["top_xs"], fb["top_desc"], fb["top_valid"],
            use_kernels=use_kernels)
    torch.cuda.synchronize()
    return out


def dispatch_step(torch, ops, feats, algs):
    """The measured matcher dispatch (`kernels/dispatch.py`) on the card, on
    a fresh cache, for every bucket the matching path reaches and for
    `DISPATCH_EXTRA`.  The path's buckets are the shapes of the scene
    pair's own top-K descriptors ``feats``, in both directions of
    ``match_pair``; the stitch's ORB lists fall in the pair's Hamming bucket,
    which phase 3b's gate that the path measures nothing holds.  Every
    bucket runs two contests: ``use_kernels`` None (on the card the
    kernel's two plans; True asks the same) and False (the torch paths, the
    plain route's).  Each must measure each of its candidates once, the
    kernel's with the matcher launched in its probes; a second round with
    the memo cleared must measure nothing (the disk answers);
    ``launch/obs.py --explain-dispatch`` must exit 0 and list every key.
    Prints each bucket's four times and both verdicts, and flags a torch
    path faster than the kernel's verdict (printed, not refused); returns
    {cache key: path}."""
    from repro_torch.kernels import dispatch
    path = fresh_dispatch_cache("chip_smoke_dispatch.json")
    dispatch.clear_memory_cache()
    card = torch.device("cuda", torch.cuda.current_device())
    path_buckets = {}
    for alg in algs:
        metric = MATCH_WIDTHS[alg][0]
        a, b = (f[alg]["top_desc"] for f in feats)
        for q, db in ((a, b), (b, a)):
            bucket = (metric, q.shape[1], q.shape[0], db.shape[0])
            path_buckets.setdefault(
                dispatch.bucket_key(metric, "cuda", *bucket[2:],
                                    bucket[1]), bucket)
    buckets = sorted(path_buckets.values(), key=str) + list(DISPATCH_EXTRA)
    verdicts = {}
    contests = [(use, *b) for b in buckets for use in (None, False)]
    t0 = time.perf_counter()
    for use, metric, width, nq, rows in contests:
        cands = dispatch.candidate_paths(metric, "cuda", rows, width, use)
        key = (dispatch.bucket_key(metric, "cuda", nq, rows, width) + "|"
               + "".join(sorted(dispatch._ABBREV[c] for c in cands)))
        m0, l0 = dispatch.measure_count, ops.launch_counts()["matcher"]
        verdicts[key] = dispatch.choose_path(metric, nq, rows, width,
                                             use_kernels=use, device=card)
        torch.cuda.synchronize()
        require(dispatch.measure_count - m0 == len(cands),
                f"dispatch {key}: {dispatch.measure_count - m0} measures for "
                f"{len(cands)} candidates")
        require((ops.launch_counts()["matcher"] > l0) == (use is None),
                f"dispatch {key}: the probes launched the matcher kernel "
                f"{ops.launch_counts()['matcher'] - l0} times")
    t_measure = time.perf_counter() - t0
    table = dispatch.explain()
    require(set(table) == set(verdicts),
            f"the cache holds {sorted(table)}, not {sorted(verdicts)}")
    log(f"matcher dispatch on the card ({len(path_buckets)} buckets of the "
        f"matching path, then {len(DISPATCH_EXTRA)} others, each with the "
        f"kernel's plans and with the torch paths; {len(verdicts)} contests "
        f"measured in {t_measure:.2f} s; probes <= {dispatch.PROBE_NQ_CAP} x "
        f"{dispatch.PROBE_NK_CAP} rows, median of {dispatch._PROBE_REPS} "
        f"host-clock reps after a warm-up; {dispatch.DEFAULT_PATH} keeps a "
        f"bucket within {dispatch.SWITCH_MARGIN}x):")
    by_bucket = collections.defaultdict(dict)
    for key, row in table.items():
        by_bucket[key.rsplit("|", 1)[0]][
            row["path"] in dispatch.CUDA_PATHS] = row
    for bucket, rows in by_bucket.items():
        kern, plain = rows[True], rows[False]
        us = {**kern["us"], **plain["us"]}
        ranked = sorted(us.items(), key=lambda kv: kv[1])
        torch_first = min(plain["us"].values()) < kern["us"][kern["path"]]
        log(f"  {bucket:28s} probe {kern['probe']}: "
            + ", ".join(f"{c} {t:.1f} us" for c, t in ranked)
            + f"; kernel verdict {kern['path']} ({kern['margin']:.2f}x), "
            f"torch verdict {plain['path']} ({plain['margin']:.2f}x), the "
            f"kernel's {min(plain['us'].values()) / us[kern['path']]:.2f}x "
            "faster than the best torch path"
            + ("  (a torch path beat the kernel)" if torch_first else ""))
    # a new process's view: the memo cleared, the file answers
    dispatch.clear_memory_cache()
    m0 = dispatch.measure_count
    for use, metric, width, nq, rows in contests:
        dispatch.choose_path(metric, nq, rows, width, use_kernels=use,
                             device=card)
    require(dispatch.measure_count == m0,
            "the second round measured again with the cache file in place")
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.obs", "--explain-dispatch"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    require(cli.returncode == 0 and str(path) in cli.stdout
            and all(f"  {key}\n" in cli.stdout for key in verdicts),
            f"--explain-dispatch (rc {cli.returncode}) does not list every "
            f"bucket:\n{cli.stdout}\n{cli.stderr[-2000:]}")
    log(f"  second round with the memo cleared: 0 measures; "
        f"--explain-dispatch lists all {len(verdicts)} contests")
    return verdicts


def same_routes(alg, k, p, max_keypoints, batch=None):
    """Kernel route ``k`` against plain route ``p`` for one algorithm:
    counts, keypoints, valid flags and packed descriptor bits equal; scores
    and float descriptors within 1e-5.  The global top-K holds
    ``4 * max_keypoints`` candidates, or K per tile for a ``batch`` of
    fewer than 4 tiles.  Returns the total count."""
    import torch
    for key in ("total_count", "per_tile_count", "top_ys", "top_xs",
                "top_valid", "keypoint_count"):
        require(torch.equal(k[key], p[key]),
                f"{alg}/{key}: kernel route != plain route")
    require(torch.allclose(k["top_scores"], p["top_scores"],
                           rtol=1e-5, atol=1e-7),
            f"{alg}/top_scores beyond tolerance")
    require(bool(torch.isfinite(k["top_scores"]).all()),
            f"{alg}: non-finite scores")
    want_k = max_keypoints * (4 if batch is None else min(4, batch))
    require(k["top_ys"].shape == (want_k,), f"{alg}: top-K shape")
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
    return int(k["total_count"])


def kernel_of(name):
    """The wrapper kernel (a key of DEVICE_NAMES) a device kernel name
    belongs to, or None for torch's own kernels."""
    for kernel, prefixes in DEVICE_NAMES.items():
        if any(p in name for p in prefixes):
            return kernel
    return None


def serve_report(label, wall, latencies, rejected, svc, log_lines):
    """One load run's figures: served, req/s, p50/p99 latency, mean batch,
    occupancy, the cache's hit rate and the programs built so far (a
    partial cache hit asks for a new algorithm subset, whose graph is
    captured when it first comes; the service's own stats)."""
    import numpy as np
    lat = np.asarray([v for v in latencies if v > 0.0])
    stats = svc.stats()
    sched = stats["scheduler"]
    out = {"served": int(len(latencies)), "rejected": int(rejected),
           "cache_hit_rate": stats["cache"]["hit_rate"], "wall_s": wall,
           "req_per_s": len(latencies) / wall,
           "p50_ms": float(np.percentile(lat, 50) * 1e3) if len(lat) else 0.0,
           "p99_ms": float(np.percentile(lat, 99) * 1e3) if len(lat) else 0.0,
           "mean_batch": sched["mean_batch"], "occupancy": sched["occupancy"],
           "batches": sched["batches"], "programs": stats["programs"]}
    log_lines.append(f"  {label}: " + json.dumps(out))
    return out


def serve_phase(torch, np, scene):
    """Phase 3d: the feature service at ``ServeConfig()`` on the card, one
    CUDA graph per (bucket, algorithm set).  Returns the per-replay
    launches of each kernel by bucket and the phase's figures."""
    import dataclasses
    import gc
    import threading
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import engine
    from repro_torch.core.bundle import tile_scene
    from repro_torch.core.job import DifetJob
    from repro_torch.data.landsat import synthetic_scene
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_driver
    from repro_torch.obs import profile as obs_profile
    from repro_torch.serve import FeatureService, ServeConfig, ServeGraph
    from repro_torch.serve.trace import TraceConfig, make_trace, tile_pool

    sets = [tuple(sorted(a)) for a in SERVE_SETS]
    seven = tuple(sorted(DRIVER_ALGORITHMS))
    figures = {}

    # 1. warm-up: capture every (bucket, set), counters at 0 just before
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    # a capture empties the allocator's cache (torch.cuda.graph), so the
    # pool is read as what stays reserved with the cache emptied on both
    # sides
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    allocated0 = torch.cuda.memory_allocated()
    prev = obs_profile.set_profiler(obs_profile.KernelProfiler())
    svc = FeatureService(ServeConfig())
    cfg_s = svc.cfg
    t0 = time.perf_counter()
    programs = svc.warmup(SERVE_SETS)
    t_warm = time.perf_counter() - t0
    stamps = obs_profile.profiler().snapshot()
    obs_profile.set_profiler(prev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    require(programs == len(cfg_s.buckets) * len(sets) == 16,
            f"{programs} programs captured, want 16")
    capture_s = {k: round(v["compile_s"], 4) for k, v in stamps.items()}
    log(f"  warm-up: {programs} programs in {t_warm:.2f} s (eager call, "
        f"capture and one replay each), seconds by program "
        + json.dumps(capture_s))
    figures["capture_s"] = capture_s
    figures["pool_reserved_mib"] = (torch.cuda.memory_reserved()
                                    - reserved0) / 2 ** 20
    figures["pool_allocated_mib"] = (torch.cuda.memory_allocated()
                                     - allocated0) / 2 ** 20
    log(f"  graph pool and static buffers: "
        f"{figures['pool_allocated_mib']:.1f} MiB allocated, "
        f"{figures['pool_reserved_mib']:.1f} MiB reserved")
    require(all(isinstance(svc.compile_cache.get(b, a), ServeGraph)
                for b in cfg_s.buckets for a in sets),
            "a program on the card is not a captured graph")

    # 2. served against direct, per bucket and set: 8 new tiles each, in
    # one batch (the batching delay is lifted so that every row is real)
    served_at = {}
    svc.scheduler.max_batch_delay_s = 60.0
    for b in cfg_s.buckets:
        cfg_b = svc.table.cfg_for(b)
        for si, algs in enumerate(sets):
            grays = [synthetic_scene(b, b, seed=7000 + 97 * b + 13 * si + i)
                     for i in range(cfg_s.max_batch)]
            handles = [svc.submit(g, algs) for g in grays]
            resps = [h.result(120) for h in handles]
            served_at[(b, algs)] = sorted({s for r in resps
                                           for s in r.timing["batch_sizes"]})
            require(served_at[(b, algs)] == [cfg_s.max_batch],
                    f"bucket {b} {algs}: served in batches of "
                    f"{served_at[(b, algs)]}, want one of {cfg_s.max_batch}")
            for g, r in zip(grays, resps):
                require(not r.fully_cached and r.bucket == b,
                        f"bucket {b} {algs}: a new tile came from the cache")
                tile, header = svc.table.pad_to_bucket(g, b)
                direct = engine.extract_features_multi(
                    tile[None], header[None], algs, cfg_b)
                plain = engine.extract_features_multi(
                    tile[None], header[None], algs, cfg_b, use_kernels=False)
                for alg in algs:
                    got = r.results[alg]
                    require(set(got) == set(direct[alg]),
                            f"{b}/{alg}: served keys differ from direct")
                    for key, v in direct[alg].items():
                        d = v.cpu().numpy()
                        require(d.dtype == got[key].dtype
                                and d.shape == got[key].shape
                                and np.array_equal(d, got[key]),
                                f"bucket {b} {algs}: served {alg}/{key} is "
                                f"not bitwise the direct result")
                    same_routes(alg, direct[alg], plain[alg],
                                cfg_b.max_keypoints_per_tile, batch=1)
    svc.scheduler.max_batch_delay_s = cfg_s.max_batch_delay_s
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    log(f"  served (one batch of {cfg_s.max_batch} each) = direct (batch 1, "
        f"eager, kernels) bitwise on every key for {len(served_at)} "
        f"(bucket, set) pairs, and = the plain route as phase 3 holds it")
    log(f"  launch counters over warm-up (eager call + capture) and "
        f"serving: {launches}")
    for name in EXTRACT_KERNELS:
        require(launches[name] >= 1, f"served path: {name} never launched")

    # 3. oversize: the 2048^2 crop, all seven algorithms, as one request
    crop = np.ascontiguousarray(scene[:SERVE_OVERSIZE, :SERVE_OVERSIZE])
    t0 = time.perf_counter()
    resp = svc.submit(crop, DRIVER_ALGORITHMS).result(300)
    t_over = time.perf_counter() - t0
    b_max = cfg_s.buckets[-1]
    split = tile_scene(crop, svc.table.cfg_for(b_max))
    require(resp.n_tiles == len(split) == 64 and resp.bucket == b_max,
            f"oversize: {resp.n_tiles} tiles at bucket {resp.bucket}")
    per = engine.extract_request_features(split.tiles, split.headers,
                                          DRIVER_ALGORITHMS,
                                          svc.table.cfg_for(b_max))
    for alg in DRIVER_ALGORITHMS:
        host = {k: v.cpu().numpy() for k, v in per[alg].items()}
        want = DifetJob._merge([{k: v[i] for k, v in host.items()}
                                for i in range(len(split))])
        got = resp.results[alg]
        require(set(got) == set(want), f"oversize {alg}: keys differ")
        for key, v in want.items():
            v = np.asarray(v)
            require(v.dtype == np.asarray(got[key]).dtype
                    and np.array_equal(v, got[key]),
                    f"oversize {alg}/{key}: merged response differs from "
                    f"the merge of the direct per-tile results")
    log(f"  oversize {SERVE_OVERSIZE}^2 crop, seven algorithms, one request:"
        f" {resp.n_tiles} tiles at bucket {b_max} in {t_over:.3f} s, batch "
        f"sizes {sorted(set(resp.timing['batch_sizes']))}; merged response "
        f"bitwise = DifetJob._merge of the direct per-tile results; totals "
        + json.dumps({a: int(resp.results[a]["total_count"])
                      for a in DRIVER_ALGORITHMS}))

    # 4. the kernels under replay: one replay per bucket, seven algorithms
    per_replay = {k: {} for k in EXTRACT_KERNELS}
    for b in cfg_s.buckets:
        g = svc.compile_cache.get(b, seven)
        t_in, h_in = svc.compile_cache.empty_batch(b)
        g(t_in, h_in)
        torch.cuda.synchronize()
        # late in this process the profiler can drop device activities,
        # the first ones of a session among them (phase 3c records 6 of
        # its 8 copies; a replay's first kernel is FAST's): each session
        # opens with small kernels of its own and runs one replay, and a
        # kernel's launches per replay read as the most any of 3 sessions
        # recorded
        counts, first = {}, []
        pad = torch.zeros(1, device="cuda")
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(16):
                    pad.add_(1)
                torch.cuda.synchronize()
                g.replay(t_in, h_in)
                torch.cuda.synchronize()
            evs = sorted((e for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA),
                         key=lambda e: e.time_range.start)
            seen = {}
            for ev in evs:
                k = kernel_of(ev.name)
                if k is not None:
                    seen[k] = seen.get(k, 0) + 1
            for k, c in seen.items():
                counts[k] = max(counts.get(k, 0), c)
            first = [e.name[:40] for e in evs[:4]]
        if not all(counts.get(k, 0) for k in EXTRACT_KERNELS):
            log(f"  bucket {b}: the replay's recorded device activities "
                f"{counts}, the last session's first {first}")
        for k in EXTRACT_KERNELS:
            per_replay[k][b] = counts.get(k, 0)
            require(counts.get(k, 0) >= 1,
                    f"bucket {b}: {k} did not launch in a replay")
    log("  kernels per replay (seven algorithms, by bucket, from "
        "torch.profiler): " + json.dumps(per_replay))
    figures["per_replay"] = per_replay

    # 6a. eager against graph: one seven-algorithm step per bucket
    step_ms = {}
    for b in cfg_s.buckets:
        g = svc.compile_cache.get(b, seven)
        step = engine.make_serve_step(seven, svc.table.cfg_for(b))
        eager = cuda_ms(lambda: step(g.tiles, g.headers))
        replay = cuda_ms(lambda: g.graph.replay())
        step_ms[b] = (eager, replay)
        log(f"  step, bucket {b} ([{cfg_s.max_batch}, "
            f"{b + 2 * svc.table.halo}^2], "
            f"seven algorithms): eager {eager:.4f} ms, replay "
            f"{replay:.4f} ms (CUDA events, median of {REPS}), "
            f"{eager / replay:.2f}x")
    figures["step_ms"] = step_ms
    svc.close()
    del svc
    gc.collect()

    # 5. load: the trace, closed loop with the cache, its repeat, without
    # the cache, and an open Poisson loop at half the uncached rate
    tcfg = TraceConfig(n_requests=SERVE_REQUESTS, seed=0,
                       tile_sizes=tuple(cfg_s.buckets),
                       unique_scenes=SERVE_SCENES,
                       algorithm_sets=tuple(SERVE_SETS))
    trace, pool = make_trace(tcfg), tile_pool(tcfg)
    lines = []

    def fresh(**kw):
        s = FeatureService(dataclasses.replace(ServeConfig(), **kw))
        s.warmup(SERVE_SETS)
        return s

    svc = fresh()
    wall, lat, rej = serve_driver.run_closed(svc, trace, pool,
                                             SERVE_CONCURRENCY)
    figures["closed_cached"] = serve_report(
        f"closed loop, concurrency {SERVE_CONCURRENCY}, cache on", wall,
        lat, rej, svc, lines)
    t0 = time.perf_counter()
    repeat = [svc.submit(pool[ev.pool_key], ev.algorithms).result(60)
              for ev in trace]
    t_rep = time.perf_counter() - t0
    require(all(r.fully_cached for r in repeat),
            f"repeat pass: {sum(not r.fully_cached for r in repeat)} "
            f"requests not fully cached")
    lines.append(f"  repeat pass: all {len(repeat)} requests fully cached, "
                 f"{t_rep:.3f} s serial ({len(repeat) / t_rep:.1f} req/s)")
    svc.close()
    del svc, repeat

    svc = fresh(cache_entries=0)
    wall, lat, rej = serve_driver.run_closed(svc, trace, pool,
                                             SERVE_CONCURRENCY)
    closed = serve_report(
        f"closed loop, concurrency {SERVE_CONCURRENCY}, cache off", wall,
        lat, rej, svc, lines)
    figures["closed_uncached"] = closed
    # the device's busy share over a window of the same loop
    window = trace[:SERVE_BUSY_REQUESTS]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve_driver.run_closed(svc, window, pool, SERVE_CONCURRENCY)
        torch.cuda.synchronize()
        busy_wall = time.perf_counter() - t0
    dev_us = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dev_us[ev.key] = ev.self_device_time_total
    busy = sum(dev_us.values()) / 1e6
    figures["busy_share"] = busy / busy_wall if busy > 0 else None
    if busy > 0:
        ours = sum(us for k, us in dev_us.items() if kernel_of(k))
        top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:6]
        lines.append(
            f"  device busy {busy:.4f} s of {busy_wall:.4f} s wall "
            f"({100 * busy / busy_wall:.1f}%) over {len(window)} requests "
            f"without cache under the profiler; the port's kernels "
            f"{ours / 1e6:.4f} s; costliest: "
            + "; ".join(f"{k[:60]} {us / 1e3:.2f} ms" for k, us in top))
    else:
        lines.append("  device busy share: the profiler recorded no device "
                     "time; not measured")
    svc.close()
    del svc

    rate = 0.5 * closed["req_per_s"]
    otrace = make_trace(dataclasses.replace(tcfg, arrival="poisson",
                                            rate=rate))
    svc = fresh(cache_entries=0)
    wall, lat, rej = serve_driver.run_open(svc, otrace, pool)
    figures["open_uncached"] = serve_report(
        f"open Poisson loop at {rate:.1f} req/s, cache off", wall, lat, rej,
        svc, lines)
    svc.close()
    del svc
    gc.collect()
    for line in lines:
        log(line)
    return figures


def same_response(want, got, what):
    """A served response's results bitwise equal to the oracle's."""
    import numpy as np
    require(set(got) == set(want), f"{what}: algorithms differ")
    for alg, res in want.items():
        require(set(got[alg]) == set(res), f"{what}: {alg} keys differ")
        for key, v in res.items():
            g = got[alg][key]
            require(v.dtype == g.dtype and v.shape == g.shape
                    and np.array_equal(v, g),
                    f"{what}: {alg}/{key} is not bitwise the oracle's")


def fleet_closed(fleet, trace, pool, concurrency):
    """Closed loop through the fleet's router: ``concurrency`` clients each
    submit a request (routed by its scene key) and wait for it.  Returns
    the wall and the per-request client latencies; a failed request fails
    the run."""
    import threading
    from repro_torch.serve.trace import scene_key
    latencies = [0.0] * len(trace)
    it = iter(range(len(trace)))
    lock = threading.Lock()
    errors = []

    def client():
        while not errors:
            with lock:
                i = next(it, None)
            if i is None:
                return
            ev = trace[i]
            t0 = time.perf_counter()
            try:
                fleet.submit(pool[ev.pool_key], ev.algorithms,
                             tenant=ev.tenant,
                             scene_key=scene_key(ev)).result(120)
            except Exception as e:  # noqa: BLE001 — raised after the join
                errors.append(e)
                return
            latencies[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=client) for _ in range(concurrency)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    require(not errors, f"fleet closed loop: {len(errors)} request(s) "
            f"failed, first {errors[0]!r}" if errors else "")
    return time.perf_counter() - t0, latencies


def fleet_phase(torch, np, single_closed):
    """Phase 3e: the replica fleet at ``ServeConfig()`` on the card.
    Returns the phase's figures."""
    import dataclasses
    import os
    import tempfile
    import threading

    from repro_torch.kernels import ops
    from repro_torch.launch import fleet as fleet_driver
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.serve import (FeatureService, Fleet, FleetConfig,
                                   ServeConfig)
    from repro_torch.serve.trace import TraceConfig, make_trace, tile_pool

    figures = {}
    buckets = ServeConfig().buckets
    tcfg = TraceConfig(n_requests=SERVE_REQUESTS, seed=0,
                       tile_sizes=tuple(buckets), unique_scenes=SERVE_SCENES,
                       algorithm_sets=tuple(SERVE_SETS))
    trace, pool = make_trace(tcfg), tile_pool(tcfg)
    torch.cuda.empty_cache()

    # the oracle: one replica on the card, no cache; one response for
    # each (tile, set) of the trace
    oracle = FeatureService(ServeConfig(cache_entries=0), name="oracle")
    oracle.warmup(SERVE_SETS)
    want = {}
    for ev in trace:
        key = (ev.pool_key, ev.algorithms)
        if key not in want:
            want[key] = oracle.submit(pool[ev.pool_key],
                                      ev.algorithms).result(120).results
    oracle.close()
    log(f"  oracle: one FeatureService(ServeConfig(cache_entries=0)) on "
        f"the card, {len(want)} distinct (tile, set) pairs of the "
        f"{len(trace)}-request trace")

    def check_all(label, accepted, responses):
        for i, (ev, resp) in enumerate(zip(accepted, responses)):
            same_response(want[(ev.pool_key, ev.algorithms)], resp.results,
                          f"{label}, request {i}")

    def spawn(n, **kw):
        t0 = time.time()
        fleet = Fleet(FleetConfig(initial_replicas=n, min_replicas=1,
                                  max_replicas=max(n, 2),
                                  warm_algorithm_sets=tuple(SERVE_SETS),
                                  proc=True, **kw))
        ready = {}
        for name, rep in fleet.replicas.items():
            info = rep.service.mailbox.read_ready()
            marker = rep.service.root / "ready.npz"
            info["ready_s"] = marker.stat().st_mtime - t0
            ready[name] = info
            require(info["device"].startswith("cuda"),
                    f"{name} runs on {info['device']}, not the card")
            for k in EXTRACT_KERNELS:
                require(info["kernels_captured"].get(k, 0) >= 1,
                        f"{name}: {k} was not captured into its graphs "
                        f"({info['kernels_captured']})")
        return fleet, ready, time.time() - t0

    # 1. process fleet: 2 workers, telemetry on, kill -9 after 256 accepted
    tmp = Path(tempfile.mkdtemp(prefix="difet-fleet-", dir=ROOT / "build"))
    m0 = obs_metrics.registry().snapshot()
    fleet, ready, t_spawn = spawn(
        2, cache_dir=str(tmp / "cache"), lease_ttl_s=1.0, telemetry=True)
    log(f"  process fleet (2 workers, ServeConfig(), shared disk tier, "
        f"telemetry on) ready in {t_spawn:.2f} s; ready markers: "
        + json.dumps({n: {k: i[k] for k in ("pid", "programs",
                                             "kernels_captured",
                                             "memory_reserved", "ready_s")}
                      for n, i in ready.items()}))
    kills = []
    sigkill = fleet.sigkill_replica

    def timed_sigkill(name):
        kills.append(time.time())
        return sigkill(name)

    fleet.sigkill_replica = timed_sigkill
    wall, responses, sheds, readmitted, accepted = fleet_driver.replay(
        fleet, trace, pool, kill_after=FLEET_KILL_AFTER)
    fleet.poll_telemetry()
    events = fleet.telemetry.events + fleet.router.drain_events()
    readmits = {e["rid"] for e in events if e.get("kind") == "readmit"}
    served, shed_n = len(responses), sum(sheds.values())
    m1 = obs_metrics.registry().snapshot()
    stale = (m1.get("difet.fleet.stale_lease_deaths", 0)
             - m0.get("difet.fleet.stale_lease_deaths", 0))
    require(len(kills) == 1 and stale >= 1,
            f"the kill -9 was not found through a stale lease ({stale})")
    require(served + shed_n == len(trace),
            f"{served} served + {shed_n} shed != {len(trace)} injected")
    require(readmitted >= 1 and readmits, "no request was re-admitted")
    check_all("process fleet", accepted, responses)
    done = [r.timing["completed_at"] for r in responses
            if r.request_id in readmits]
    require(len(done) == len(readmits),
            f"{len(readmits)} re-admitted, {len(done)} of them answered")
    figures["kill"] = {
        "served": served, "shed": shed_n, "readmitted": len(readmits),
        "wall_s": wall, "kill_to_last_readmitted_s": max(done) - kills[0],
        "stale_lease_deaths": int(stale),
        "ready_s": {n: i["ready_s"] for n, i in ready.items()},
        "reserved_mib": {n: i["memory_reserved"] / 2 ** 20
                         for n, i in ready.items()}}
    stats = fleet.stats()
    fleet.close()
    fleet_driver.chaos_summary(fleet, sheds)
    log(f"  kill -9 after {FLEET_KILL_AFTER} accepted: {served} served, "
        f"{shed_n} shed of {len(trace)}, {len(readmits)} re-admitted, the "
        f"last re-admitted answered "
        f"{figures['kill']['kill_to_last_readmitted_s']:.3f} s after the "
        f"kill; every response bitwise = the oracle; routing affinity "
        f"{stats['routed_affinity']}, spill {stats['routed_spill']}, "
        f"cache hits {stats['total_cache_hits']}")

    # 2. thread fleet: 2 replicas, forced up to 3 while a replay runs (the
    # third captures its graphs beside the others' replays), then drained
    # back to 2; counters at 0 just before, read just after
    ops.reset_launch_counts()
    fleet = Fleet(FleetConfig(
        serve=ServeConfig(cache_entries=0), initial_replicas=2,
        min_replicas=2, max_replicas=3, warm_algorithm_sets=tuple(SERVE_SETS),
        slo_p99_s=1e9, scale_up_queue_per_replica=-1.0,
        scale_down_grace_ticks=1))
    out = {}

    def run_replay():
        try:
            out["replay"] = fleet_driver.replay(fleet, trace, pool)
        except Exception as e:  # noqa: BLE001 — raised after the join
            out["error"] = e

    replayer = threading.Thread(target=run_replay)
    replayer.start()
    while fleet.router.submitted < FLEET_KILL_AFTER and replayer.is_alive():
        time.sleep(0.005)
    t0 = time.perf_counter()
    at_start = fleet.router.submitted
    up = fleet.autoscale_tick()
    at_end = fleet.router.submitted
    t_up = time.perf_counter() - t0
    replayer.join(300)
    require(not replayer.is_alive() and "error" not in out,
            f"thread-fleet replay failed: {out.get('error')!r}")
    require(up.startswith("scale_up:") and at_end > at_start,
            f"scale-up under traffic: {up}, {at_start} -> {at_end} "
            f"submitted during it")
    _, responses, sheds, _, accepted = out["replay"]
    require(len(responses) == len(trace) and not sheds,
            f"thread fleet: {len(responses)} responses, sheds {sheds}")
    check_all("thread fleet", accepted, responses)
    widest = max(responses, key=lambda r: len(r.algorithms))
    per = {n: r["submitted"] for n, r in fleet.stats()["replicas"].items()}
    down = fleet.autoscale_tick()
    require(down.startswith("scale_down:")
            and len(fleet.ready_replicas()) == 2,
            f"drain back to 2: {down}, ready {fleet.ready_replicas()}")
    launches = ops.launch_counts()
    for k in EXTRACT_KERNELS:
        require(launches[k] >= 1, f"thread fleet: {k} never launched")
    fleet.close()
    figures["scale_up_s"] = t_up
    log(f"  thread fleet 2 -> 3 -> 2 under a {len(trace)}-request replay: "
        f"{up} (16 graphs captured in {t_up:.2f} s while requests "
        f"{at_start}-{at_end} came in), then {down}; zero dropped, every "
        f"response bitwise = the oracle; requests by replica {per}; "
        f"launch counters {launches}")

    # 3. closed loop, cache off, concurrency 16, on 1, 2 and 4 workers
    fleet, ready, t_spawn = spawn(4, serve=ServeConfig(cache_entries=0))
    names = sorted(fleet.replicas)
    closed = {}
    for n in FLEET_REPLICA_COUNTS:
        for i, name in enumerate(names):
            fleet.router.set_accepting(name, i < n)
        wall, lat = fleet_closed(fleet, trace, pool, SERVE_CONCURRENCY)
        lat = np.asarray(lat)
        closed[n] = {"req_per_s": len(trace) / wall,
                     "p50_ms": float(np.percentile(lat, 50) * 1e3),
                     "p99_ms": float(np.percentile(lat, 99) * 1e3),
                     "wall_s": wall}
    fleet.close()
    figures["closed"] = closed
    figures["spawn4_s"] = t_spawn
    figures["ready4_s"] = {n: i["ready_s"] for n, i in ready.items()}
    figures["reserved4_mib"] = {n: i["memory_reserved"] / 2 ** 20
                                for n, i in ready.items()}
    log(f"  4 workers ready in {t_spawn:.2f} s (each "
        + ", ".join(f"{v:.2f}" for v in figures["ready4_s"].values())
        + " s; reserved "
        + ", ".join(f"{v:.1f}" for v in figures["reserved4_mib"].values())
        + " MiB)")
    for n, c in closed.items():
        log(f"  closed loop, cache off, concurrency {SERVE_CONCURRENCY}, "
            f"{n} process replica(s): {c['req_per_s']:.2f} req/s, p50 "
            f"{c['p50_ms']:.2f} ms, p99 {c['p99_ms']:.2f} ms")
    log(f"  (phase 3d, one in-process service: "
        f"{single_closed['req_per_s']:.2f} req/s, p50 "
        f"{single_closed['p50_ms']:.2f} ms, p99 "
        f"{single_closed['p99_ms']:.2f} ms)")

    # the host cost of one request on the wire, step by step (median of
    # 50 trips in this process): the parent writes a 256 tile's request,
    # the worker claims it and writes a response of the widest set, the
    # parent reads and decodes it; each message one .npz in the mailbox
    from repro_torch.serve.proc import _decode_response, _encode_response
    from repro_torch.serve.transport import WorkerMailbox
    probe = WorkerMailbox(tmp / "probe")
    big = pool[next(k for k in pool if k[1] == buckets[-1])]
    steps = {"parent_send": [], "worker_claim": [], "worker_respond": [],
             "parent_collect": []}
    for _ in range(50):
        t = [time.perf_counter()]
        probe.send_request("r", {"algorithms": list(widest.algorithms)},
                           {"image": big})
        t.append(time.perf_counter())
        [(_, _, arrays)] = probe.claim_requests()
        t.append(time.perf_counter())
        probe.send_response("r", *_encode_response(widest))
        t.append(time.perf_counter())
        _decode_response(*probe.try_read_response("r"))
        t.append(time.perf_counter())
        (probe.resp / "r.npz").unlink()
        for key, a, b in zip(steps, t, t[1:]):
            steps[key].append((b - a) * 1e3)
    n_arrays = sum(len(v) for v in widest.results.values())
    figures["wire_ms"] = {k: statistics.median(v) for k, v in steps.items()}
    figures["wire_ms"]["response_arrays"] = n_arrays
    log(f"  the wire, host ms a step (median of 50; a 256 tile out, a "
        f"{len(widest.algorithms)}-algorithm response of {n_arrays} arrays "
        f"back): " + ", ".join(f"{k} {figures['wire_ms'][k]:.3f}"
                               for k in steps))

    # 4. the reference's own gates, as subprocesses, all at once
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for args in FLEET_SMOKES:
        f = open(tmp / f"smoke-{len(procs)}.log", "w+")
        procs.append((args, f, subprocess.Popen(
            [sys.executable, *args], cwd=ROOT, env=env, stdout=f,
            stderr=subprocess.STDOUT)))
    t0 = time.perf_counter()
    for args, f, p in procs:
        try:
            rc = p.wait(timeout=max(1.0, 300 - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            p.kill()
            rc = p.wait()
        f.seek(0)
        tail = f.read().strip().splitlines()[-3:]
        f.close()
        log(f"  python {' '.join(args)}: exit {rc}; " + " | ".join(tail))
        require(rc == 0, f"{' '.join(args)} exited {rc}")
    figures["smokes_s"] = time.perf_counter() - t0
    return figures


def build_phase(build):
    """Phase 1: every kernel library built at once, and no spill in any
    entry function."""
    t0 = time.perf_counter()
    built = build.build_all()
    log(f"build: {len(built)} kernel libraries built with nvcc "
        f"(sm_90a) from {CSRC} in {time.perf_counter() - t0:.2f} s")
    # the spill gate reads the ptxas report that the build keeps beside each
    # library, so it holds for libraries built by an earlier run as well
    for name in build.SOURCES:
        lib = build.library_path(name)
        require(lib.exists() and lib.with_suffix(".log").exists(),
                f"{name}: the library or its build report is missing")
        entries = ptxas_entries(lib.with_suffix(".log").read_text())
        require(entries, f"{name}: the build report lists no kernel")
        for entry, regs, smem, spill in entries:
            log(f"  {name}: {entry:28s} {regs:3d} registers, {smem:6d} B "
                f"static shared, spills {spill}")
            require(spill == "0 B stores, 0 B loads",
                    f"{name}: {entry} spills registers")


def same_bits(got, want, what):
    """Two {key: tensor or array} results bit for bit, dtypes included."""
    import torch
    require(set(got) == set(want), f"{what}: other keys")
    for key in want:
        a, b = (torch.as_tensor(x).cpu() for x in (got[key], want[key]))
        require(a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b), f"{what}/{key}: differs from the "
                "one-device run")


def card_kernels(torch, fn, tries=3):
    """{CUDA device index: {wrapper kernel}} of the device kernels one
    ``fn()`` ran, by the profiler's device index (a session that recorded
    no device kernel is run again, up to ``tries`` times)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)
        seen = collections.defaultdict(set)
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                kernel = kernel_of(ev.name)
                if kernel is not None:
                    seen[ev.device_index].add(kernel)
        if seen:
            return dict(seen)
    return {}


def peak_gib(torch, fn, cards):
    """{card: GiB that one ``fn()`` allocated beyond what was held}."""
    base = {}
    for i in cards:
        torch.cuda.synchronize(i)
        base[i] = torch.cuda.memory_allocated(i)
        torch.cuda.reset_peak_memory_stats(i)
    fn()
    for i in cards:
        torch.cuda.synchronize(i)
    return {i: (torch.cuda.max_memory_allocated(i) - base[i]) / 2 ** 30
            for i in cards}


def mesh_phase(torch, np, dev, meshes, bundle, bundle256, stitch_store):
    """The data mesh (``distributed/``, the mesh branches of the engine,
    the job and the match phase): the paper scene (seven algorithms), SIFT
    at tile 256, a ``DifetJob`` and the stitch store's ``MatchPhase`` on
    each mesh of ``meshes``, each bit for bit the one-device run on
    ``dev`` (``mesh=None``), with every kernel of each path launched on
    every card of the mesh (the per-device launch counts, and the
    profiler's device index for the scene and tile 256 together); times
    the scene and tile 256 with the slices staged
    on their cards in advance, beside the one-device runs, and the peak
    memory per card of a scene.  Returns the figures."""
    import shutil
    from repro_torch.configs.difet_paper import DifetConfig, PAPER_ALGORITHMS
    from repro_torch.core import engine, mosaic
    from repro_torch.core.bundle import BundleStore, TileBundle
    from repro_torch.core.job import DifetJob
    from repro_torch.distributed import shard
    from repro_torch.kernels import ops

    cfg, cfg256 = bundle.cfg, bundle256.cfg
    figures = {"meshes": [[str(d) for d in m] for m in meshes]}
    tiles = torch.from_numpy(bundle.tiles).to(dev)
    headers = torch.from_numpy(bundle.headers).to(dev)
    tiles256 = torch.from_numpy(bundle256.tiles).to(dev)
    headers256 = torch.from_numpy(bundle256.headers).to(dev)

    def one():
        return engine.extract_features_multi(tiles, headers,
                                             PAPER_ALGORITHMS, cfg,
                                             device=dev)

    def one256():
        return engine.extract_features_multi(tiles256, headers256,
                                             ("sift",), cfg256, device=dev)

    want, want256 = one(), one256()
    figures["one_device_scene_s"] = host_s(one, REPS)
    figures["one_device_tile256_s"] = host_s(one256, REPS)
    log(f"  one device ({dev}, mesh=None): scene "
        f"{figures['one_device_scene_s']:.4f} s, tile-256 SIFT "
        f"{figures['one_device_tile256_s']:.4f} s (median of {REPS})")

    def launched(by_device, cards, kernels, what):
        for card in cards:
            for name in kernels:
                require(by_device[name].get(card, 0) >= 1,
                        f"{what}: kernel {name} was not launched on card "
                        f"{card}")

    # the job's bundle (4 shards of 13, 13, 12, 12 tiles) and the stitch
    # store's scene pairs, all of them (6 pairs of 4 scenes, one chunk)
    job_root = ROOT / "build" / "chip_smoke_mesh_job"
    shutil.rmtree(job_root, ignore_errors=True)
    algs = ",".join(PAPER_ALGORITHMS)

    def job(tag, **kw):
        store = BundleStore(job_root / tag)
        store.put("b0", TileBundle(bundle.tiles[:MESH_JOB_TILES],
                                   bundle.headers[:MESH_JOB_TILES], cfg))
        DifetJob(store, algs, **kw).run()
        return {alg: store.get_result(f"b0.{alg}")
                for alg in PAPER_ALGORITHMS}

    sstore = BundleStore(stitch_store)
    scenes = sstore.list()
    pairs = [(scenes[i], scenes[j]) for i in range(len(scenes))
             for j in range(i + 1, len(scenes))]

    def match(tag, **kw):
        phase = mosaic.MatchPhase(
            sstore, pairs, "orb", pairs_per_step=8,
            manifest_path=job_root / f"match_{tag}.json", **kw)
        phase.run()
        return phase.results()

    want_job = job("one", device=dev)
    want_match = match("one", device=dev)
    require(len(want_match) == len(pairs), "the match phase skipped pairs")

    figures["per_mesh"] = []
    for mesh in meshes:
        cards = sorted({d.index for d in mesh})
        tag = f"{mesh.size} entries on card(s) {cards}"
        fig = {"entries": mesh.size, "cards": cards}
        ext = engine.make_distributed_multi_extractor(PAPER_ALGORITHMS, cfg,
                                                      mesh)
        ext256 = engine.make_distributed_multi_extractor(("sift",), cfg256,
                                                         mesh)
        st, sh = shard(bundle.tiles, mesh), shard(bundle.headers, mesh)
        st256 = shard(bundle256.tiles, mesh)
        sh256 = shard(bundle256.headers, mesh)
        # the paper scene, counters at 0 just before
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        got = ext(st, sh)
        torch.cuda.synchronize()
        by_device = ops.launch_counts_by_device()
        launched(by_device, cards, MAIN_KERNELS, f"scene on {tag}")
        require(ops.launch_counts()["scalespace"] == 0,
                f"scene on {tag}: the scale-space kernel ran at tile 512")
        for alg in PAPER_ALGORITHMS:
            same_bits(got[alg], want[alg], f"scene on {tag}: {alg}")
        fig["scene_launches"] = {k: {str(c): n for c, n in v.items()}
                                 for k, v in by_device.items()}
        del got
        # SIFT at tile 256: the fused octave on every card
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        got = ext256(st256, sh256)
        torch.cuda.synchronize()
        launched(ops.launch_counts_by_device(), cards, ("scalespace", "blur"),
                 f"tile-256 SIFT on {tag}")
        same_bits(got["sift"], want256["sift"], f"tile-256 SIFT on {tag}")
        del got
        # the job and the match phase
        ops.reset_launch_counts()
        got_job = job(f"mesh{len(figures['per_mesh'])}", mesh=mesh)
        launched(ops.launch_counts_by_device(), cards, MAIN_KERNELS,
                 f"DifetJob on {tag}")
        for alg in PAPER_ALGORITHMS:
            same_bits(got_job[alg], want_job[alg], f"DifetJob on {tag}: {alg}")
        ops.reset_launch_counts()
        got_match = match(f"mesh{len(figures['per_mesh'])}", mesh=mesh)
        torch.cuda.synchronize()
        launched(ops.launch_counts_by_device(), cards, MATCH_KERNELS,
                 f"MatchPhase on {tag}")
        require(got_match.keys() == want_match.keys(),
                f"MatchPhase on {tag}: other pairs")
        for pair, r in got_match.items():
            same_bits(r, want_match[pair], f"MatchPhase on {tag}: {pair}")
        # every card ran harris, fast, blur and scalespace: the profiler
        seen = card_kernels(torch, lambda: (ext(st, sh),
                                            ext256(st256, sh256)))
        for card in cards:
            require(set(EXTRACT_KERNELS) <= seen.get(card, set()),
                    f"the profiler saw {sorted(seen.get(card, ()))} on card "
                    f"{card} of {tag}")
        fig["profiler_kernels"] = {str(c): sorted(k) for c, k in seen.items()}
        # times, slices staged on their cards in advance
        fig["scene_s"] = host_s(lambda: ext(st, sh), REPS)
        fig["tile256_s"] = host_s(lambda: ext256(st256, sh256), REPS)
        fig["peak_gib"] = {str(c): g for c, g in peak_gib(
            torch, lambda: ext(st, sh), cards).items()}
        log(f"  mesh of {tag}: scene, tile-256 SIFT, DifetJob "
            f"({MESH_JOB_TILES} tiles, 4 shards) and MatchPhase "
            f"({len(pairs)} pairs) bitwise the one-device runs; harris, "
            f"fast, blur, scalespace and matcher launched on every card "
            f"(profiler: {fig['profiler_kernels']}); scene "
            f"{fig['scene_s']:.4f} s, tile-256 SIFT {fig['tile256_s']:.4f} s "
            f"(median of {REPS}); peak GiB a card {fig['peak_gib']}")
        figures["per_mesh"].append(fig)
        del st, sh, st256, sh256, ext, ext256
    shutil.rmtree(job_root, ignore_errors=True)
    return figures


def mesh_table1(torch, dev, meshes, cfg):
    """Table 1 per card count: ``run_scaling`` over phase 3c's three RGBA
    scenes (12 batches of 64, one worker, the best of 2 passes) with each
    batch split over each mesh of more than one card (a mesh of one card
    runs the one-device sweep), beside the one-device sweep; per-batch
    counts equal across all.  Splits each sweep's time in two: the
    prefetcher alone (ingest and the copies to the cards, no extraction:
    one pass that stages all 12 batches) and the extraction alone (those
    staged batches, each result brought to the host as the sweep does; the
    second of two passes).
    Returns {label: {algorithm: seconds}}, the split and the counts."""
    from repro_torch.data.pipeline import (Prefetcher, iter_tile_batches,
                                           pinned_empty)
    from repro_torch.launch import scale
    t0 = time.perf_counter()
    readers = scale.build_scene_set(ROOT / "build" / "chip_smoke_table1", 3,
                                    cfg.scene_hw)
    log(f"  Table 1 on the meshes: {len(readers)} RGBA band scenes of "
        f"{readers[0].shape}, written or reopened in "
        f"{time.perf_counter() - t0:.1f} s; batches of {BATCH_TILES}, one "
        f"worker, {','.join(SWEEP_ALGORITHMS)}")
    runs = {"one_device": dict(device=dev)}
    runs.update({f"cards_{m.size}": dict(mesh=m) for m in meshes
                 if m.size > 1})

    def sync_all():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    def extract_s(fn, batches):
        sync_all()
        t = time.perf_counter()
        for b in batches:
            for r in fn(b.tiles, b.headers).values():
                for v in r.values():
                    v.cpu()
        return time.perf_counter() - t

    times, split, counts = {}, {}, {}
    for label, kw in runs.items():
        rows = scale.run_scaling(readers, cfg, SWEEP_ALGORITHMS, (1,),
                                 batch_tiles=BATCH_TILES, repeats=2, **kw)
        times[label] = {r["algorithm"]: r["t"][1] for r in rows}
        counts[label] = {r["algorithm"]: r["batch_counts"] for r in rows}
        require(all(r["n_batches"] == 12 and r["total_count"] > 0
                    for r in rows), f"Table 1 ({label}): batches or counts")
        require(counts[label] == counts["one_device"],
                f"Table 1 ({label}): per-batch counts differ from the "
                f"one-device sweep's")
        sync_all()
        t = time.perf_counter()
        with Prefetcher(iter_tile_batches(readers, cfg, BATCH_TILES,
                                          alloc=pinned_empty),
                        depth=scale.PREFETCH_DEPTH, device_put=True,
                        **kw) as pf:
            batches = [b for _, b in pf]
        sync_all()
        split[label] = {"prefetcher_s": time.perf_counter() - t}
        for alg in SWEEP_ALGORITHMS:
            fn = scale.make_batch_extractor((alg,), cfg, **kw)
            extract_s(fn, batches)
            split[label][f"extract_{alg}_s"] = extract_s(fn, batches)
        del batches
        log(f"    {label:10s} sweep " + "  ".join(
            f"{alg} {t:.4f} s" for alg, t in times[label].items())
            + f"; prefetcher alone {split[label]['prefetcher_s']:.4f} s; "
            "extraction alone " + "  ".join(
                f"{alg} {split[label][f'extract_{alg}_s']:.4f} s"
                for alg in SWEEP_ALGORITHMS))
    return times, split, {alg: sum(c)
                          for alg, c in counts["one_device"].items()}


def lm_batch(torch, cfg, b, s, gen, dev, dtype):
    """Random tokens (and the VLM's patches, Whisper's frames) on ``dev``."""
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                     generator=gen, device=dev)}
    if cfg.n_image_patches:
        batch["patches"] = torch.randn(b, cfg.n_image_patches, cfg.d_model,
                                       generator=gen, device=dev).to(dtype)
    if cfg.is_enc_dec:
        batch["frames"] = torch.randn(b, cfg.encoder_seq_len, cfg.d_model,
                                      generator=gen, device=dev).to(dtype)
    return batch


def max_abs(a, b):
    return float((a.float() - b.float()).abs().max())


def lm_require_close(torch, got, want, tol, what):
    require(bool(torch.isfinite(got).all()) and
            bool(torch.isfinite(want).all()), f"{what}: logits not finite")
    require(torch.allclose(got.float(), want.float(), **tol),
            f"{what}: max abs difference {max_abs(got, want):.4g} outside "
            f"rtol {tol['rtol']} / atol {tol['atol']}")


class NoDropRoutes:
    """Within the block: every MoE layer runs at no-drop capacity (a
    factor of n_experts / k, so C >= the tokens routed), and each routing
    records its tokens' expert ids.  Restores the configs and
    ``moe.route`` on exit."""

    def __init__(self, torch, model):
        import dataclasses

        from repro_torch.models import moe as M
        self.M, self.ids = M, []
        self.layers = [m for m in model.modules() if isinstance(m, M.MoE)]
        self.saved = [m.cfg for m in self.layers]
        for m in self.layers:
            moe = m.cfg.moe
            m.cfg = m.cfg.replace(moe=dataclasses.replace(
                moe, capacity_factor=moe.n_experts / moe.n_experts_per_tok))

    def __enter__(self):
        route = self.route = self.M.route

        def recording(p, c, x, seq=None):
            out = route(p, c, x, seq)
            self.ids.append(out[1].sort(-1).values)
            return out

        self.M.route = recording
        return self

    def __exit__(self, *exc):
        self.M.route = self.route
        for m, cfg in zip(self.layers, self.saved):
            m.cfg = cfg


def lm_teacher_forced(torch, model, cfg, batch, steps, hold=None):
    """The forward's logits over the first ``steps`` tokens against
    ``steps`` decode steps from an empty cache, position by position (the
    VLM without its image: decode takes none).  The MoE archs run at
    no-drop capacity (decode never drops: 8 slots an expert for B tokens),
    and a position that the two runs routed to other experts in some layer
    (bf16 rounding that differs between the runs flips a near tie) is
    reported and not held; only the first ``hold`` positions are held when
    it is given.  Returns (max abs difference over the held positions, the
    flipped positions, the pairs the forward would drop at the configured
    capacity)."""
    b = batch["tokens"].shape[0]
    sub = dict(batch, tokens=batch["tokens"][:, :steps])
    if cfg.n_image_patches:
        sub["patches"] = batch["patches"][:, :0]
    with NoDropRoutes(torch, model) as fwd, torch.inference_mode():
        full, _ = model(sub)
    cache = model.init_cache(b, steps)
    if cfg.is_enc_dec:
        _, cross = model.prefill(sub)
        cache["xk"].copy_(cross["xk"])
        cache["xv"].copy_(cross["xv"])
    step_logits, step_ids = [], []
    for i in range(steps):
        with NoDropRoutes(torch, model) as dec:
            logits, cache = model.decode_step(
                cache, sub["tokens"][:, i:i + 1], i)
        step_logits.append(logits[:, 0])
        step_ids.append(dec.ids)
    got = torch.stack(step_logits, 1)
    held = torch.ones((b, steps), dtype=torch.bool, device=got.device)
    dropped = 0
    for layer, ids in enumerate(fwd.ids):         # [B*steps, k] per layer
        ids = ids.view(b, steps, -1)
        dec_ids = torch.stack([s[layer] for s in step_ids], 1)
        held &= (ids == dec_ids).all(-1)
        moe = cfg.moe
        dropped += int((~fwd.M.dispatch(ids.view(b * steps, -1),
                                        moe.n_experts,
                                        fwd.M.capacity(cfg, b * steps))[4]
                        ).sum())
    require(held.float().mean() >= 0.5, f"teacher-forced decode: "
            f"{int((~held).sum())} of {held.numel()} positions were routed "
            f"apart")
    require(bool(torch.isfinite(got).all() and torch.isfinite(full).all()),
            "teacher-forced decode: logits not finite")
    flipped = [tuple(map(int, ij)) for ij in torch.nonzero(~held)]
    if hold is not None:
        held[:, hold:] = False
    if held.any():
        lm_require_close(torch, got[held], full[held], LM_DECODE_TOL,
                         f"{steps}-token teacher-forced decode against "
                         f"forward")
    return max_abs(got[held], full[held]) if held.any() else None, \
        max_abs(got, full), flipped, dropped


def lm_card_against_cpu(torch, np, arch, dev):
    """``arch``'s reduced config in float32, the same weights (drawn on the
    CPU, copied to the card): forward logits within LM_EXACT_TOL, and 8
    prompt + 8 greedy steps teacher-forced on the CPU's tokens, each step's
    logits within LM_EXACT_TOL and its token equal wherever the CPU's
    top-two gap exceeds LM_TIE_GAP.  Returns the near ties (step, row)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch).reduced().replace(dtype="float32",
                                             remat="nothing")
    cpu = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(11))
    card = build_model(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    batch = lm_batch(torch, cfg, 2, 32, torch.Generator().manual_seed(12),
                     "cpu", torch.float32)
    with torch.inference_mode():
        want, _ = cpu(batch)
        got, _ = card({k: v.to(dev) for k, v in batch.items()})
    lm_require_close(torch, got.cpu(), want, LM_EXACT_TOL,
                     f"{arch} reduced float32 forward, card against CPU")
    caches = [m.init_cache(2, 16) for m in (cpu, card)]
    if cfg.is_enc_dec:
        for m, c in zip((cpu, card), caches):
            sub = {k: v.to(m.device) for k, v in batch.items()}
            _, cross = m.prefill(sub)
            c["xk"].copy_(cross["xk"])
            c["xv"].copy_(cross["xv"])
    fed = batch["tokens"][:, :8]
    near = []
    for i in range(16):
        tok = fed[:, i:i + 1]
        want, caches[0] = cpu.decode_step(caches[0], tok, i)
        got, caches[1] = card.decode_step(caches[1], tok.to(dev), i)
        lm_require_close(torch, got.cpu(), want, LM_EXACT_TOL,
                         f"{arch} reduced float32 decode step {i}, card "
                         f"against CPU")
        top2 = want[:, -1].topk(2).values
        sure = (top2[:, 0] - top2[:, 1]) > LM_TIE_GAP
        nxt = want[:, -1].argmax(-1)
        require(torch.equal(got[:, -1].cpu().argmax(-1)[sure], nxt[sure]),
                f"{arch}: greedy token of step {i} differs, card against CPU")
        near += [(i, int(r)) for r in torch.nonzero(~sure).flatten()]
        if i >= 7:
            fed = torch.cat([fed, nxt[:, None]], 1)
    del cpu, card
    return near


def lm_phase(torch, np):
    """Phase 3g: the LM substrate's serving path (``repro_torch.models``,
    ``serve/lm.py``) on the card.  Returns the phase's figures."""
    import torch.nn.functional as F

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import attention as A
    from repro_torch.models import build_model
    from repro_torch.models.model import param_count
    from repro_torch.serve.lm import greedy_generate
    dev = torch.device("cuda", torch.cuda.current_device())
    flags = {"allow_tf32": torch.backends.cuda.matmul.allow_tf32,
             "allow_bf16_reduced_precision_reduction":
                 torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}
    log(f"phase 3g: the LM serving path, bf16 at full width, B {LM_BATCH}; "
        f"matmul flags as found: {flags}")
    figures = {"flags": flags, "archs": {}}
    for seed, arch in enumerate(sorted(ARCH_IDS)):
        cfg = get_config(arch)
        full_layers = cfg.n_layers
        if arch in LM_DEPTH_CUTS:
            cfg = cfg.replace(n_layers=LM_DEPTH_CUTS[arch])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = build_model(cfg).init(
            torch.Generator(device=dev).manual_seed(seed))
        gen = torch.Generator(device=dev).manual_seed(100 + seed)
        batch = lm_batch(torch, cfg, LM_BATCH, LM_PROMPT, gen, dev,
                         torch.bfloat16)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        weight_gib = sum(p.numel() * p.element_size()
                         for p in model.parameters()) / 2 ** 30
        # prefill against forward
        logits_pre, _ = model.prefill(batch)
        with torch.inference_mode():
            logits_fwd, _ = model(batch)
        lm_require_close(torch, logits_pre[:, 0], logits_fwd[:, -1],
                         dict(rtol=1e-3, atol=1e-3),
                         f"{arch}: prefill's last logits against forward's")
        pre_diff = max_abs(logits_pre[:, 0], logits_fwd[:, -1])
        del logits_fwd
        prefill_ms = cuda_ms(lambda: model.prefill(batch), reps=3, warmup=1)
        # teacher-forced decode against forward over the same tokens
        dec_diff, dec_all, dec_near, dropped = lm_teacher_forced(
            torch, model, cfg, batch, LM_TEACHER,
            hold=0 if arch in LM_F32_DECODE else None)
        # greedy generation, twice, bitwise
        prompt = batch["tokens"][:, :LM_GREEDY[0]]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out1 = greedy_generate(model, prompt, LM_GREEDY[1])
        torch.cuda.synchronize()
        greedy_s = time.perf_counter() - t1
        out2 = greedy_generate(model, prompt, LM_GREEDY[1])
        require(torch.equal(out1, out2), f"{arch}: two greedy runs differ")
        require(tuple(out1.shape) == (LM_BATCH, LM_GREEDY[1]),
                f"{arch}: greedy output shape {tuple(out1.shape)}")
        # a decode step's time by the cache's size (every slot is read)
        step_ms = {}
        tok = prompt[:, :1]
        for slots in LM_CACHE_SLOTS:
            cache = model.init_cache(LM_BATCH, slots)
            logits, _ = model.decode_step(cache, tok, LM_TEACHER)
            require(bool(torch.isfinite(logits).all()),
                    f"{arch}: decode logits not finite at {slots} slots")
            step_ms[slots] = cuda_ms(
                lambda: model.decode_step(cache, tok, LM_TEACHER))
            del cache
        peak_gib = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        row = dict(n_layers=cfg.n_layers, full_layers=full_layers,
                   depth_cut=arch in LM_DEPTH_CUTS,
                   params=param_count(model), weight_gib=weight_gib,
                   peak_gib=peak_gib, init_s=init_s, prefill_ms=prefill_ms,
                   decode_ms={str(k): v for k, v in step_ms.items()},
                   greedy_s=greedy_s,
                   greedy_tok_s=LM_BATCH * LM_GREEDY[1] / greedy_s,
                   prefill_vs_forward_max_abs=pre_diff,
                   decode_vs_forward_max_abs=dec_diff,
                   decode_vs_forward_max_abs_all=dec_all,
                   decode_routed_apart=dec_near, forward_drops=dropped)
        figures["archs"][arch] = row
        cut = (f"depth cut {full_layers} -> {cfg.n_layers} layers"
               if arch in LM_DEPTH_CUTS else f"full depth {cfg.n_layers}")
        log(f"  {arch:17s} {cut}; {weight_gib:.2f} GiB of weights, peak "
            f"{peak_gib:.2f} GiB; prefill {LM_BATCH}x{LM_PROMPT} "
            f"{prefill_ms:.2f} ms (max abs to forward {pre_diff:.3g}); "
            f"decode step {step_ms[LM_CACHE_SLOTS[0]]:.2f} ms at "
            f"{LM_CACHE_SLOTS[0]} slots, {step_ms[LM_CACHE_SLOTS[1]]:.2f} ms "
            f"at {LM_CACHE_SLOTS[1]}; teacher-forced decode max abs "
            + (f"{dec_all:.3g} (not held in bf16, see the float32 run)"
               if arch in LM_F32_DECODE else
               f"{dec_diff:.3g} at every position")
            + (f" but those routed apart {dec_near} (MoE at no-drop "
               f"capacity; the configured one would drop {dropped} pairs)"
               if cfg.moe is not None else "") + f"; greedy {LM_GREEDY[0]}+{LM_GREEDY[1]} "
            f"{greedy_s:.2f} s ({row['greedy_tok_s']:.1f} new tokens/s), "
            f"two runs bitwise")
        del model, batch, logits_pre, out1, out2, prompt, tok
        if arch in LM_F32_DECODE:
            torch.cuda.empty_cache()
            f32 = build_model(cfg.replace(dtype="float32")).init(
                torch.Generator(device=dev).manual_seed(seed))
            batch = lm_batch(torch, cfg, LM_BATCH, LM_TEACHER,
                             torch.Generator(device=dev).manual_seed(
                                 100 + seed), dev, torch.float32)
            held_diff, all_diff, _, _ = lm_teacher_forced(
                torch, f32, cfg, batch, LM_TEACHER,
                hold=LM_F32_DECODE[arch])
            row["decode_f32"] = dict(held_positions=LM_F32_DECODE[arch],
                                     max_abs_held=held_diff,
                                     max_abs_all=all_diff)
            log(f"  {arch:17s} float32 at full width: teacher-forced decode "
                f"against forward max abs {held_diff:.3g} over the first "
                f"{LM_F32_DECODE[arch]} positions (held), {all_diff:.3g} "
                f"over all {LM_TEACHER}")
            del f32, batch
    torch.cuda.empty_cache()

    # the card against the CPU: reduced configs, float32, the same weights
    near = {}
    for arch in sorted(ARCH_IDS):
        near[arch] = lm_card_against_cpu(torch, np, arch, dev)
    figures["card_vs_cpu_near_ties"] = near
    log(f"  card = CPU in float32 on every arch's reduced config (logits "
        f"within rtol/atol 1e-4, greedy tokens equal above a gap of "
        f"{LM_TIE_GAP}); near ties (step, row): {near}")

    # long context at full width: the online path inside the model
    arch, s_long = LM_LONG
    cfg = get_config(arch)
    model = build_model(cfg).init(torch.Generator(device=dev).manual_seed(7))
    gen = torch.Generator(device=dev).manual_seed(8)
    batch = lm_batch(torch, cfg, 1, s_long, gen, dev, torch.bfloat16)
    online_calls = [0]
    online = A.attention_online

    def counting(*args, **kw):
        online_calls[0] += 1
        return online(*args, **kw)

    A.attention_online = counting
    try:
        logits, _ = model.prefill(batch)
    finally:
        A.attention_online = online
    require(online_calls[0] == cfg.n_layers,
            f"the S {s_long} prefill took the online path in "
            f"{online_calls[0]} of {cfg.n_layers} layers")
    require(bool(torch.isfinite(logits).all()), "long prefill not finite")
    long_ms = cuda_ms(lambda: model.prefill(batch), reps=3, warmup=1)
    del model, batch, logits
    # the two algorithms held on float32 inputs (in bf16 each rounds its
    # output, and einsum its probabilities, to a bf16 ulp of 2^-7 at 1),
    # then timed on the path's bf16
    hd = cfg.resolved_head_dim
    qf, kf, vf = (torch.randn(1, s_long, cfg.n_heads, hd, generator=gen,
                              device=dev) for _ in range(3))
    online_diff = max_abs(A.attention_online(qf, kf, vf, causal=True),
                          A.attention_einsum(qf, kf, vf, causal=True))
    require(online_diff <= 2e-3, f"attention_online against attention_einsum "
            f"at S {s_long}, float32: max abs {online_diff:.4g} > 2e-3")
    q, k, v = (x.to(torch.bfloat16) for x in (qf, kf, vf))
    del qf, kf, vf
    ein = A.attention_einsum(q, k, v, causal=True)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    sdpa_diff = max_abs(sdpa.transpose(1, 2), ein)
    long = dict(arch=arch, seq=s_long, prefill_ms=long_ms,
                online_layers=online_calls[0], online_vs_einsum=online_diff,
                online_ms=cuda_ms(lambda: A.attention_online(
                    q, k, v, causal=True)),
                einsum_ms=cuda_ms(lambda: A.attention_einsum(
                    q, k, v, causal=True)),
                sdpa_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True)),
                sdpa_vs_einsum=sdpa_diff)
    figures["long"] = long
    log(f"  long context: {arch} prefill B 1 x S {s_long} {long_ms:.2f} ms "
        f"(the online path in all {cfg.n_layers} layers); attention "
        f"[1,{s_long},{cfg.n_heads},{hd}] causal: online = einsum within "
        f"{online_diff:.3g} (float32 inputs); bf16 online "
        f"{long['online_ms']:.3f} ms, einsum {long['einsum_ms']:.3f} ms, "
        f"F.scaled_dot_product_attention "
        f"{long['sdpa_ms']:.3f} ms (the library yardstick, not on the path; "
        f"max abs to einsum {sdpa_diff:.3g})")
    del q, k, v, qt, kt, vt, ein, sdpa
    torch.cuda.empty_cache()
    return figures


def train_batch(torch, cfg, b, s, gen, dev, dtype):
    """``lm_batch`` and random next-token labels."""
    batch = lm_batch(torch, cfg, b, s, gen, dev, dtype)
    batch["labels"] = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                    device=dev)
    return batch


def state_gib(state):
    return sum(t.numel() * t.element_size() for k in ("m", "v")
               for t in state["opt"][k].values()) / 2 ** 30


def all_finite(torch, tensors):
    return bool(torch.stack([torch.isfinite(t).all() for t in tensors]).all())


def train_main_path(torch, ckpt_dir):
    """smollm-135m through ``launch.train.main``: TRAIN_STEPS steps
    uninterrupted, then TRAIN_RESUME_AT steps checkpointed and a resume to
    TRAIN_STEPS.  Each step's metrics are recorded by wrapping the step
    function the launcher builds."""
    import numpy as np

    from repro_torch.launch import train as T
    made, record = T.make_train_step, []

    def recording(*args, **kw):
        step = made(*args, **kw)

        def timed(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            record.append(dict(s=time.perf_counter() - t0,
                               loss=float(m["loss"]),
                               grad_norm=float(m["grad_norm"]),
                               lr=float(m["lr"])))
            return state, m
        return timed

    T.make_train_step = recording
    try:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        full = T.main(TRAIN_MAIN + ["--steps", str(TRAIN_STEPS)])
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        steps = record[:]
        ck = ["--ckpt-dir", str(ckpt_dir)]
        part = T.main(TRAIN_MAIN + ["--steps", str(TRAIN_RESUME_AT)] + ck
                      + ["--ckpt-every", str(TRAIN_RESUME_AT)])
        resumed = T.main(TRAIN_MAIN + ["--steps", str(TRAIN_STEPS)] + ck
                         + ["--resume"])
    finally:
        T.make_train_step = made
    require(len(full) == TRAIN_STEPS and len(resumed) == TRAIN_STEPS
            - TRAIN_RESUME_AT, "train: the runs took other step counts")
    require(all(np.isfinite([r["loss"] for r in record]
                            + [r["grad_norm"] for r in record])),
            "train: a loss or grad norm is not finite")
    require(part == full[:TRAIN_RESUME_AT], "train: the checkpointed run "
            "differs from the uninterrupted one before the checkpoint")
    tail = full[TRAIN_RESUME_AT:]
    require(resumed == tail, f"train: the resumed losses differ from the "
            f"uninterrupted run (max abs "
            f"{max(abs(a - b) for a, b in zip(resumed, tail))})")
    first, last = np.mean(full[:10]), np.mean(full[-10:])
    require(last < first, f"train: loss did not fall ({first} -> {last})")
    step_s = statistics.median(r["s"] for r in steps[1:])
    return dict(losses=full, resumed_bitwise=True, first10=float(first),
                last10=float(last), step_ms=1e3 * step_s,
                grad_norms=[r["grad_norm"] for r in steps],
                tokens_per_s=8 * 256 / step_s,     # the launcher's B x S
                peak_gib=peak,
                run_s=sum(r["s"] for r in steps))


def train_card_against_cpu(torch, arch, dev):
    """One train step of ``arch``'s reduced config in float32 from one set
    of weights (3g's seeds) on the CPU and the card: loss and grad norm
    within TRAIN_F32_TOL, and every updated parameter too, except where the
    CPU's |g| lies within that tolerance of 0 (the first AdamW step, about
    lr * sign(g), may go the other way there: atol 2 lr)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.train.step import (TrainStepConfig, make_init_fn,
                                        make_train_step)
    cfg = get_config(arch).reduced().replace(dtype="float32",
                                             remat="nothing")
    batch = train_batch(torch, cfg, 2, 32, torch.Generator().manual_seed(12),
                        "cpu", torch.float32)
    opt, scfg = AdamW(), TrainStepConfig(learning_rate=TRAIN_F32_LR)
    models, states = {}, {}
    for where, gen in (("cpu", torch.Generator().manual_seed(11)),
                       (dev, torch.Generator(device=dev))):
        models[where] = build_model(cfg, device=where)
        states[where] = make_init_fn(models[where], opt, scfg)(gen)
    models[dev].load_state_dict(models["cpu"].state_dict())
    loss, _ = models["cpu"].loss(batch)
    grads = dict(zip(states["cpu"]["params"], torch.autograd.grad(
        loss, list(states["cpu"]["params"].values()))))
    cpu, mc = make_train_step(models["cpu"], opt, scfg)(states["cpu"], batch)
    card, md = make_train_step(models[dev], opt, scfg)(
        states[dev], {k: v.to(dev) for k, v in batch.items()})
    for k in ("loss", "grad_norm"):
        require(np.isclose(float(md[k]), float(mc[k]), **TRAIN_F32_TOL),
                f"{arch} reduced float32 train step, card against CPU: {k} "
                f"{float(md[k])} against {float(mc[k])}")
    worst, flips = 0.0, 0
    tol = TRAIN_F32_TOL
    for k, want in cpu["params"].items():
        got = card["params"][k].detach().cpu()
        g = grads[k].abs()
        flip = g <= tol["atol"] + tol["rtol"] * g
        flips += int(flip.sum())
        want = want.detach()
        require(torch.allclose(got[~flip], want[~flip], **tol) and
                torch.allclose(got[flip], want[flip], rtol=0,
                               atol=2 * TRAIN_F32_LR),
                f"{arch} reduced float32 train step, card against CPU: "
                f"parameter {k} max abs {max_abs(got, want):.4g}")
        worst = max(worst, max_abs(got[~flip], want[~flip])
                    if (~flip).any() else 0.0)
    return dict(loss=float(md["loss"]), max_abs_param=worst,
                held_at_2lr=flips)


def train_phase(torch):
    """Phase 3h: the LM substrate's training path on the card
    (``launch/train.py`` -> ``train/step.py`` -> ``models/*`` under
    autograd and remat -> ``optim/adamw.py``; ``checkpoint/``).  Runs in
    torch's deterministic mode (``CUBLAS_WORKSPACE_CONFIG`` is set before
    the first GEMM of the run), so that a resume and the remat policies
    are held bit for bit.  Returns the phase's figures."""
    import shutil

    from repro_torch.checkpoint import CheckpointManager, flatten_state
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import build_model
    from repro_torch.models.model import param_count
    from repro_torch.optim import AdamW
    from repro_torch.train.step import (TrainStepConfig, make_init_fn,
                                        make_train_step)
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.use_deterministic_algorithms(True)
    ckpt_root = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    figures = {"deterministic": True, "archs": {}}
    try:
        # the main path: smollm-135m through the launcher, with its resume
        t0 = time.perf_counter()
        main = train_main_path(torch, ckpt_root / "main")
        main["wall_s"] = time.perf_counter() - t0
        figures["main"] = main
        log(f"  smollm-135m through launch/train.py (B 8 x S 256, lr 3e-3, "
            f"remat dots, bf16): {TRAIN_STEPS} steps, loss "
            f"{main['first10']:.4f} -> {main['last10']:.4f} (means of the "
            f"first and last 10); step "
            f"{main['step_ms']:.2f} ms (median of steps 2-{TRAIN_STEPS}), "
            f"{main['tokens_per_s']:.0f} tokens/s, peak "
            f"{main['peak_gib']:.2f} GiB; resumed at {TRAIN_RESUME_AT} "
            f"bitwise the uninterrupted run; {main['wall_s']:.1f} s for the "
            f"three runs")

        # every other arch: 2 steps at full width in bf16
        for seed, arch in enumerate(sorted(ARCH_IDS)):
            if arch in TRAIN_SKIP_FULL or arch == "smollm-135m":
                continue
            cfg = get_config(arch)
            full_layers = cfg.n_layers
            if arch in TRAIN_DEPTH_CUTS:
                cfg = cfg.replace(n_layers=TRAIN_DEPTH_CUTS[arch])
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            model = build_model(cfg)
            opt, scfg = AdamW(), TrainStepConfig()
            state = make_init_fn(model, opt, scfg)(
                torch.Generator(device=dev).manual_seed(seed))
            step = make_train_step(model, opt, scfg)
            batch = train_batch(torch, cfg, TRAIN_BATCH, TRAIN_SEQ,
                                torch.Generator(device=dev).manual_seed(
                                    200 + seed), dev, torch.bfloat16)
            params = list(state["params"].values())
            before = [p.detach().reshape(-1)[:4096].clone() for p in params]
            times = []
            for _ in range(TRAIN_ARCH_STEPS):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                state, m = step(state, batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t1)
                require(bool(torch.isfinite(m["loss"])) and
                        bool(torch.isfinite(m["grad_norm"])),
                        f"{arch}: train step loss or grad norm not finite")
            require(all_finite(torch, params),
                    f"{arch}: an updated parameter is not finite")
            require(any(not torch.equal(p.detach().reshape(-1)[:4096], b)
                        for p, b in zip(params, before)),
                    f"{arch}: no parameter changed")
            n = param_count(model)
            step_s = statistics.median(times[1:])
            tokens = TRAIN_BATCH * TRAIN_SEQ
            row = dict(n_layers=cfg.n_layers, full_layers=full_layers,
                       depth_cut=arch in TRAIN_DEPTH_CUTS, remat=cfg.remat,
                       params=n, step_ms=1e3 * step_s,
                       first_step_ms=1e3 * times[0],
                       tokens_per_s=tokens / step_s,
                       mfu=6 * n * tokens / step_s / BF16_PEAK_FLOPS,
                       weight_gib=sum(p.numel() * p.element_size()
                                      for p in params) / 2 ** 30,
                       state_gib=state_gib(state),
                       peak_gib=(torch.cuda.max_memory_allocated() - base)
                       / 2 ** 30,
                       loss=float(m["loss"]), grad_norm=float(m["grad_norm"]))
            figures["archs"][arch] = row
            cut = (f"depth cut {full_layers} -> {cfg.n_layers}"
                   if arch in TRAIN_DEPTH_CUTS
                   else f"full depth {cfg.n_layers}")
            log(f"  {arch:17s} {cut}, remat {cfg.remat}: step "
                f"{row['step_ms']:.1f} ms (first {row['first_step_ms']:.1f}), "
                f"{row['tokens_per_s']:.0f} tokens/s, model-FLOP share "
                f"{100 * row['mfu']:.2f}% of {BF16_PEAK_FLOPS:.3g}; weights "
                f"{row['weight_gib']:.2f} + m, v {row['state_gib']:.2f} GiB, "
                f"peak {row['peak_gib']:.2f} GiB; loss {row['loss']:.4f}, "
                f"grad norm {row['grad_norm']:.3f}")
            del model, state, step, batch, params, before, m
            gc.collect()
        torch.cuda.empty_cache()

        # remat on the card: one batch, three policies, bitwise grads
        cfg = get_config("smollm-135m")
        model = build_model(cfg).init(
            torch.Generator(device=dev).manual_seed(3))
        batch = train_batch(torch, cfg, 8, 256, torch.Generator(
            device=dev).manual_seed(4), dev, torch.bfloat16)
        params = dict(model.named_parameters())
        grads, peaks, fwd_bwd_ms = {}, {}, {}

        def fwd_bwd():
            loss, _ = model.loss(batch)
            return torch.autograd.grad(loss, list(params.values()))

        for remat in ("nothing", "dots", "full"):
            model.cfg = cfg.replace(remat=remat)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fwd_bwd_ms[remat] = 1e3 * host_s(fwd_bwd, 3)
            grads[remat] = fwd_bwd()
            torch.cuda.synchronize()
            peaks[remat] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        model.cfg = cfg
        for remat in ("dots", "full"):
            require(all(torch.equal(a, b) for a, b in
                        zip(grads[remat], grads["nothing"])),
                    f"remat {remat}: grads differ from remat nothing")
        require(peaks["full"] <= peaks["dots"] <= peaks["nothing"],
                f"remat peaks not ordered full <= dots <= nothing: {peaks}")
        figures["remat_peak_gib"] = peaks
        log(f"  remat on smollm-135m, B 8 x S 256: grads bitwise equal; peak "
            f"GiB nothing {peaks['nothing']:.3f}, dots {peaks['dots']:.3f}, "
            f"full {peaks['full']:.3f}")

        # where smollm's step goes: forward, forward + backward by remat
        # policy, the update, and one step (remat dots) under the profiler
        def fwd():
            with torch.no_grad():
                model.loss(batch)

        opt = AdamW()
        state = {"params": params, "opt": opt.init(params),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        g = dict(zip(params, grads["nothing"]))
        del grads
        breakdown = dict(fwd_ms=1e3 * host_s(fwd, 3),
                         fwd_bwd_ms=fwd_bwd_ms,
                         update_ms=1e3 * host_s(lambda: opt.update(
                             g, state["opt"], params, 1e-3), 3))
        del g
        step = make_train_step(model, opt, TrainStepConfig())
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        dev_events = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in dev_events) / 1e3
        breakdown.update(profiled_step_ms=1e3 * wall, busy_ms=busy,
                         device_kernels=sum(e.count for e in dev_events))
        figures["smollm_breakdown"] = breakdown
        log(f"  smollm-135m's step, B 8 x S 256, deterministic: forward "
            f"{breakdown['fwd_ms']:.1f} ms; forward + backward "
            + ", ".join(f"{k} {v:.1f}" for k, v in fwd_bwd_ms.items())
            + f" ms; update {breakdown['update_ms']:.1f} ms; one step (dots) "
            f"under the profiler {1e3 * wall:.1f} ms, "
            + (f"the card busy {busy:.1f} ms ({100 * busy / (1e3 * wall):.1f}"
               f"%), {breakdown['device_kernels']} kernels" if busy > 0 else
               "no device time recorded (busy share not measured)"))

        # checkpoints across devices: card -> CPU and CPU -> card, bitwise
        cm = CheckpointManager(ckpt_root / "cross")
        t1 = time.perf_counter()
        cm.save(state, 1)
        save_s = time.perf_counter() - t1
        on_cpu, _ = cm.restore(state, device="cpu")
        leaves = flatten_state(state)
        for (k, a), (_, b) in zip(leaves, flatten_state(on_cpu)):
            require(b.device.type == "cpu" and b.dtype == a.dtype and
                    torch.equal(a.cpu(), b), f"checkpoint card -> CPU: {k}")
        cm.save(on_cpu, 2)
        on_card, _ = cm.restore(on_cpu, step=2, device=dev)
        for (k, a), (_, b) in zip(leaves, flatten_state(on_card)):
            require(b.device == dev and torch.equal(a, b),
                    f"checkpoint CPU -> card: {k}")
        figures["checkpoint"] = dict(
            leaves=len(leaves), save_s=save_s,
            bytes=sum(v.numel() * v.element_size() for _, v in leaves))
        log(f"  checkpoint of smollm-135m's train state "
            f"({figures['checkpoint']['bytes'] / 2 ** 30:.2f} GiB, "
            f"{len(leaves)} leaves, bf16/fp32/int32) written on the card "
            f"restores on the CPU bitwise, and back ({save_s:.1f} s a save)")
        del model, params, state, on_cpu, on_card, batch, step, leaves
        torch.cuda.empty_cache()

        # the card against the CPU: every reduced config, float32, one step
        figures["card_vs_cpu"] = {
            arch: train_card_against_cpu(torch, arch, dev)
            for arch in sorted(ARCH_IDS)}
        log(f"  card = CPU in float32, one train step on every arch's reduced "
            f"config (loss, grad norm, parameters within rtol/atol 1e-4; "
            f"atol 2 lr where |g| is within it of 0): max abs parameter "
            f"difference " + ", ".join(
                f"{a} {r['max_abs_param']:.3g}"
                for a, r in figures["card_vs_cpu"].items()))
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ckpt_root, ignore_errors=True)
    return figures

# the dry run's prediction of one train step of ``arch`` (``layers`` deep,
# 0: the config's) at B x S on a fake mesh of ``shape`` (its own process)
_PREDICT = """
import json, sys
sys.path.insert(0, {src!r})
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch.dryrun import lower_cell
from repro_torch.launch.mesh import make_fake_mesh, release_mesh
cfg = get_config({arch!r})
if {layers}:
    cfg = cfg.replace(n_layers={layers})
mesh = make_fake_mesh({shape!r}, ("data", "model"))
r = lower_cell(cfg, ShapeConfig("step", {s}, {b}, "train"), mesh)
release_mesh()
open({out!r}, "w").write(json.dumps(r))
"""


def start_predict(out, arch, shape, b, s, layers=0):
    code = _PREDICT.format(src=str(ROOT / "src"), arch=arch, shape=shape,
                           b=b, s=s, layers=layers, out=str(out))
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def finish(proc, what, timeout=DRYRUN_TIMEOUT):
    """Wait for a subprocess of this phase; fail with its output's end."""
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise SystemExit(f"chip_smoke: {what} took over {timeout} s")
    require(proc.returncode == 0,
            f"{what} exited {proc.returncode}:\n{out[-3000:]}")
    return out


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def local_state_bytes(state) -> int:
    from repro_torch.launch.dryrun import _local_bytes
    return _local_bytes(state)


def card_rates(torch, dev):
    """The card's own rates: a bf16 GEMM of 8192^3 and a device-to-device
    copy of 4 GiB (bytes read + written over the time)."""
    n = 8192
    a = torch.randn(n, n, device=dev, dtype=torch.bfloat16)
    b = torch.randn(n, n, device=dev, dtype=torch.bfloat16)
    mm_ms = cuda_ms(lambda: a @ b)
    del a, b
    src = torch.empty(4 * 2 ** 30, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    cp_ms = cuda_ms(lambda: dst.copy_(src))
    del src, dst
    torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return dict(card=smi.stdout.strip().splitlines()[0],
                bf16_matmul_8192_ms=mm_ms,
                bf16_flops=2 * n ** 3 / (mm_ms / 1e3),
                copy_4gib_ms=cp_ms,
                copy_bytes_per_s=2 * 4 * 2 ** 30 / (cp_ms / 1e3))


def counted_launch_step(torch, dev, mesh):
    """One train step of launch/train.py's smollm-135m (B 8 x S 256) on
    ``mesh``, eager on the card under the dry run's per-rank counter:
    (FLOPs, local state bytes, peak bytes allocated)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_lm_batch
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import specs as SP
    from repro_torch.launch import train as T
    from repro_torch.launch.analysis import OpCounter
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    from repro_torch.train.step import TrainStepConfig, make_train_step
    cfg = get_config("smollm-135m")
    model = build_model(cfg, dev).init(
        torch.Generator(device=dev).manual_seed(0))
    opt, scfg = AdamW(), TrainStepConfig(learning_rate=3e-3)
    with T._on_mesh(mesh, cfg):
        state, _ = T.place_state(model, opt, scfg, mesh)
        nbytes = local_state_bytes(state)
        batch = {k: torch.from_numpy(v).long().to(dev) for k, v in
                 synthetic_lm_batch(LAUNCH_B, LAUNCH_S, cfg.vocab_size,
                                    seed=0).items()}
        batch = SH.distribute(batch, SP.to_named(
            SP.batch_pspecs(batch, mesh), mesh), mesh)
        step = make_train_step(model, opt, scfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with OpCounter() as counter:
            step(state, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    del model, state, batch, step
    torch.cuda.empty_cache()
    return counter.flops, nbytes, peak


def same_checkpoints(a, b, what):
    import numpy as np
    za, zb = np.load(a / "tensors.npz"), np.load(b / "tensors.npz")
    require(set(za.files) == set(zb.files), f"{what}: other leaves")
    for k in za.files:
        require(za[k].dtype == zb[k].dtype
                and za[k].tobytes() == zb[k].tobytes(), f"{what}: {k} differs")
    return len(za.files)


def analysis_phase(torch):
    """Phase 3i: the LM substrate's sharding and analysis on the card (see
    the constants above).  Returns the phase's figures."""
    import shutil

    import torch.distributed as dist

    from repro_torch.launch import analysis as AN
    from repro_torch.launch import train as T
    from repro_torch.launch.mesh import make_lm_host_mesh
    dev = torch.device("cuda", torch.cuda.current_device())
    root = ROOT / "build" / "chip_dryrun"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs = {f"{a} {s}": subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
         "--shape", s, "--out", str(root), "--force"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for a, s in DRYRUN_CELLS}
    predict = start_predict(root / "predict_1x1.json", "smollm-135m",
                            (1, 1), LAUNCH_B, LAUNCH_S)
    figures = {"card": card_rates(torch, dev),
               "constants": dict(card=AN.CARD, peak_flops=AN.PEAK_FLOPS,
                                 hbm_bytes_per_s=AN.HBM_BW,
                                 link_bytes_per_s=AN.LINK_BW)}
    r = figures["card"]
    log(f"  the card's rates ({r['card']}): bf16 GEMM 8192^3 "
        f"{r['bf16_matmul_8192_ms']:.3f}"
        f" ms = {r['bf16_flops'] / 1e12:.1f} TFLOP/s (the dry run's constant "
        f"{AN.PEAK_FLOPS / 1e12:.0f}); a 4 GiB device copy "
        f"{r['copy_4gib_ms']:.3f} ms = {r['copy_bytes_per_s'] / 1e12:.3f} "
        f"TB/s read + written (constant {AN.HBM_BW / 1e12:.2f}); links "
        f"{AN.LINK_BW / 1e9:.0f} GB/s a card (not measured on one card)")

    # smollm through launch.train, mesh-less and on a one-rank NCCL mesh
    ck = ROOT / "build" / "chip_mesh_train"
    shutil.rmtree(ck, ignore_errors=True)
    args = TRAIN_MAIN + ["--steps", str(MESH_TRAIN_STEPS), "--ckpt-dir"]
    torch.use_deterministic_algorithms(True)
    try:
        t1 = time.perf_counter()
        plain = T.main(args + [str(ck / "plain")])
        plain_s = time.perf_counter() - t1
        dist.init_process_group("nccl",
                                init_method=f"tcp://localhost:{free_port()}",
                                rank=0, world_size=1)
        try:
            t1 = time.perf_counter()
            on_mesh = T.main(args + [str(ck / "mesh")])
            mesh_s = time.perf_counter() - t1
            require(on_mesh == plain, f"one-rank mesh: losses differ from "
                    f"the mesh-less run: {on_mesh} vs {plain}")
            step_dir = f"step_{MESH_TRAIN_STEPS:010d}"
            leaves = same_checkpoints(ck / "plain" / step_dir,
                                      ck / "mesh" / step_dir,
                                      "one-rank mesh against mesh-less")
            mesh = make_lm_host_mesh()
            flops, nbytes, peak = counted_launch_step(torch, dev, mesh)
        finally:
            dist.destroy_process_group()
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ck, ignore_errors=True)
    finish(predict, "the dry run's (1, 1) prediction")
    pred = json.loads((root / "predict_1x1.json").read_text())
    require(nbytes == pred["state_bytes_per_device"],
            f"local state bytes {nbytes} != the dry run's "
            f"{pred['state_bytes_per_device']}")
    rel = abs(flops - pred["cost"]["hlo_flops"]) / pred["cost"]["hlo_flops"]
    require(rel <= 0.01, f"per-device FLOPs {flops} vs the dry run's "
            f"{pred['cost']['hlo_flops']} ({rel:.2%})")
    figures["one_rank_mesh"] = dict(
        steps=MESH_TRAIN_STEPS, losses=plain, bitwise=True,
        checkpoint_leaves=leaves, plain_s=plain_s, mesh_s=mesh_s)
    figures["predicted_1x1"] = dict(
        state_bytes=nbytes, flops_card=flops,
        flops_dryrun=pred["cost"]["hlo_flops"], flops_rel=rel,
        peak_gib_dryrun=pred["memory"]["peak_bytes_per_device"] / 2 ** 30,
        peak_gib_card=peak / 2 ** 30)
    log(f"  smollm-135m through launch.train, {MESH_TRAIN_STEPS} steps "
        f"(deterministic): on a one-rank NCCL mesh bitwise the mesh-less "
        f"run (losses, {leaves} checkpoint leaves; {mesh_s:.1f} s against "
        f"{plain_s:.1f} s)")
    p = figures["predicted_1x1"]
    log(f"  the dry run's (1, 1) step against the card's: local state "
        f"{nbytes} bytes equal; FLOPs {flops:.6e} counted on the card vs "
        f"{p['flops_dryrun']:.6e} ({rel:.4%}); peak "
        f"{p['peak_gib_dryrun']:.2f} GiB predicted, "
        f"{p['peak_gib_card']:.2f} GiB max_memory_allocated")
    cells = {}
    for name, proc in procs.items():
        finish(proc, f"launch.dryrun {name}")
        a, s = name.split()
        d = json.loads((root / f"16x16__{a}__{s}.json").read_text())
        if s.startswith("decode"):
            # the reference's in_shardings of None: replicated tokens
            require(d["decode_inputs"]["tokens"] == ["R", "R"],
                    f"dry run {name}: decode tokens placed "
                    f"{d['decode_inputs']['tokens']}, not replicated")
        cells[name] = dict(
            counted=d["counted"], decode_inputs=d.get("decode_inputs"),
            trace_s=d["compile_s"], peak_gib=d["memory"][
                "peak_bytes_per_device"] / 2 ** 30,
            flops=d["cost"]["hlo_flops"], hbm_bytes=d["cost"]["hlo_bytes"],
            collective_bytes=d["collective_bytes"],
            roofline=d["roofline"])
        c = cells[name]
        route = (c["counted"] if isinstance(c["counted"], str)
                 else c["counted"]["route"])
        tokens = (f"; tokens {c['decode_inputs']['tokens']}"
                  if c["decode_inputs"] else "")
        log(f"  dry run {name} on 16x16 (the H100's constants): "
            f"{c['peak_gib']:.2f} GiB a card, {c['flops']:.3e} FLOPs, "
            f"collectives {c['collective_bytes']}, compute "
            f"{c['roofline']['compute_s']:.3e} s, memory "
            f"{c['roofline']['memory_s']:.3e} s, collective "
            f"{c['roofline']['collective_s']:.3e} s ({c['trace_s']} s; "
            f"counted {route}{tokens})")
    figures["dryrun"] = cells
    figures["wall_s"] = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    return figures


def lm_worker_main(kind: str, shape, out_dir: Path) -> int:
    """One rank of a ``torchrun`` LM run on a mesh of cards (``--mesh-cards``):
    ``smollm`` trains smollm-135m LM_MESH_STEPS steps at full width (a
    (4, 1) run saves its final state; a (2, 2) run restores it after
    training and holds it bitwise); ``dsv3`` trains deepseek-v3-671b cut to
    DSV3_LAYERS layers DSV3_STEPS steps (B x S of DSV3_BATCH) and keeps its
    MoE layer's input, router and routes of the first step;
    ``dsv3_prefill`` runs its chunked prefill (`prefill_worker`).  Writes
    rank 0's figures."""
    if kind == "dsv3_prefill":
        return prefill_worker(shape, out_dir)
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.checkpoint import CheckpointManager, flatten_state
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_lm_batch
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import specs as SP
    from repro_torch.launch import train as T
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.train.step import TrainStepConfig, make_train_step
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl")
    rank = dist.get_rank()
    mesh = SH.LMMesh.from_device_mesh(init_device_mesh(
        "cuda", shape, mesh_dim_names=("data", "model")))
    if kind == "smollm":
        cfg, steps, b, s = (get_config("smollm-135m"), LM_MESH_STEPS,
                            LAUNCH_B, LAUNCH_S)
    else:
        cfg, steps = (get_config("deepseek-v3-671b").replace(
            n_layers=DSV3_LAYERS), DSV3_STEPS)
        b, s = DSV3_BATCH[tuple(shape)]
    t0 = time.perf_counter()
    model = build_model(cfg, dev).init(
        torch.Generator(device=dev).manual_seed(0))
    opt = AdamW()
    scfg = TrainStepConfig(learning_rate=LM_MESH_LR)
    seen, mem = {}, {}
    with T._on_mesh(mesh, cfg):
        state, shardings = T.place_state(model, opt, scfg, mesh)
        torch.cuda.empty_cache()
        init_s = time.perf_counter() - t0
        nbytes = local_state_bytes(state)
        moes = [m for m in model.modules() if hasattr(m, "routes")]
        if moes:
            moes[0].routes = []

            def keep_input(mod, args):      # the step updates the router
                if "x" not in seen:         # in place: keep copies
                    seen.update(x=args[0].full_tensor().detach().clone(),
                                router=mod.router.full_tensor().detach()
                                .clone())
                    # the layer's own high-water: bytes above its entry
                    mem.update(before=torch.cuda.max_memory_allocated(),
                               base=torch.cuda.memory_allocated())
                    torch.cuda.reset_peak_memory_stats()

            def moe_done(mod, args, out):
                if "moe" not in mem:
                    mem["moe"] = (torch.cuda.max_memory_allocated()
                                  - mem["base"])
            hooks = (moes[0].register_forward_pre_hook(keep_input),
                     moes[0].register_forward_hook(moe_done))
        step = make_train_step(model, opt, scfg, cosine_schedule(
            LM_MESH_LR, warmup_steps=LM_MESH_WARMUP, total_steps=steps))
        torch.cuda.reset_peak_memory_stats()
        losses, norms, times = [], [], []
        for i in range(steps):
            batch = {k: torch.from_numpy(v).long().to(dev) for k, v in
                     synthetic_lm_batch(b, s, cfg.vocab_size,
                                        seed=i).items()}
            batch = SH.distribute(batch, SP.to_named(
                SP.batch_pspecs(batch, mesh), mesh), mesh)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            if moes and i == 0:
                for h in hooks:
                    h.remove()
                idx, keep = moes[0].routes[0]     # (remat may rerun it)
                moes[0].routes = None
                seen.update(idx=idx.cpu(), keep=keep.cpu(),
                            router=seen["router"].cpu(), x=seen["x"].cpu())
        peak = max(torch.cuda.max_memory_allocated(), mem.get("before", 0))
        out = dict(kind=kind, mesh=list(shape), losses=losses,
                   grad_norms=norms, step_s=times, init_s=init_s,
                   state_bytes=nbytes, peak_bytes=peak,
                   moe_forward_bytes=mem.get("moe"), tokens=b * s)
        ck = CheckpointManager(out_dir / "ckpt_4x1")
        if kind == "smollm" and tuple(shape) == (4, 1):
            ck.save(state, steps)                  # rank 0 writes
        elif kind == "smollm":
            restored, _ = ck.restore(state, shardings=shardings, mesh=mesh)
            z = np.load(ck.root / f"step_{steps:010d}" / "tensors.npz")
            for k, t in flatten_state(restored):
                full = t.full_tensor()
                if full.dtype == torch.bfloat16:
                    want = torch.from_numpy(z[k].view(np.int16)).view(
                        torch.bfloat16)
                else:
                    want = torch.from_numpy(np.asarray(z[k]))
                require(tuple(t.placements) == tuple(_tree_at(shardings, k))
                        and torch.equal(full.cpu(), want),
                        f"restore (4, 1) -> {shape}: {k}")
            out["restored_leaves"] = len(z.files)
    all_bytes = [None] * dist.get_world_size()
    dist.all_gather_object(all_bytes, (nbytes, peak))
    out["state_bytes_all"] = [x[0] for x in all_bytes]
    out["peak_bytes_all"] = [x[1] for x in all_bytes]
    if rank == 0:
        tag = "x".join(map(str, shape))
        (out_dir / f"{kind}_{tag}.json").write_text(json.dumps(out))
        if seen:
            torch.save(seen, out_dir / f"{kind}_{tag}_routes.pt")
    dist.barrier()
    dist.destroy_process_group()
    return 0


def prefill_worker(shape, out_dir: Path) -> int:
    """One rank of deepseek-v3-671b's bf16 prefill (DSV3_LAYERS layers,
    weights from seed 0, serving placements) on the mesh ``shape``, B x S
    of DSV3_PREFILL in the config's ``prefill_chunks``: the logits, the
    first MoE layer's input and router, its routes and drops per chunk,
    and the prefill's ms (the second of two runs, host clock ending in a
    synchronize).  Writes rank 0's figures."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_lm_batch
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import specs as SP
    from repro_torch.launch import train as T
    from repro_torch.models import build_model
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl")
    mesh = SH.LMMesh.from_device_mesh(init_device_mesh(
        "cuda", shape, mesh_dim_names=("data", "model")))
    cfg = get_config("deepseek-v3-671b").replace(n_layers=DSV3_LAYERS)
    _, b, s = DSV3_PREFILL
    model = build_model(cfg, dev).init(
        torch.Generator(device=dev).manual_seed(0))
    seen, times = {}, []
    with T._on_mesh(mesh, cfg), torch.no_grad():
        SH.shard_module(model, mesh, SP.to_named(SP.params_pspecs(
            SP.params_abstract(model), mesh, serving=True), mesh))
        torch.cuda.empty_cache()
        tokens = torch.from_numpy(synthetic_lm_batch(
            b, s, cfg.vocab_size, seed=0)["tokens"]).long().to(dev)
        batch = {"tokens": tokens}
        batch = SH.distribute(batch, SP.to_named(SP.batch_pspecs(
            batch, mesh), mesh), mesh)
        moe = next(m for m in model.modules() if hasattr(m, "routes"))
        moe.routes = []

        def keep_input(mod, args):
            if "x" not in seen:
                seen.update(x=args[0].full_tensor().cpu(),
                            router=mod.router.full_tensor().cpu())
        hook = moe.register_forward_pre_hook(keep_input)
        for i in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = model.prefill(batch)
            logits = logits.full_tensor()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if i == 0:
                hook.remove()
                seen["routes"] = [(idx.cpu(), keep.cpu())
                                  for idx, keep in moe.routes]
                moe.routes = None
                seen["logits"] = logits.float().cpu()
        peak = torch.cuda.max_memory_allocated()
    if dist.get_rank() == 0:
        seen.update(prefill_s=times, peak_bytes=peak, chunks=cfg.prefill_chunks)
        torch.save(seen, out_dir / f"dsv3_prefill_{'x'.join(map(str, shape))}"
                   ".pt")
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _tree_at(tree, key):
    for part in key.split("/"):
        tree = tree[part]
    return tree


def torchrun_lm_raw(kind, shape, out_dir, n):
    """``chip_smoke.py --lm-worker`` on ``n`` cards under torchrun."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(n), str(ROOT / "chip_smoke.py"),
           "--lm-worker", kind, "x".join(map(str, shape)), str(out_dir)]
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    require(done.returncode == 0, f"torchrun {kind} {shape} exited "
            f"{done.returncode}:\n{done.stdout[-2000:]}\n"
            f"{done.stderr[-4000:]}")


def torchrun_lm(kind, shape, out_dir, n):
    """`torchrun_lm_raw`, then rank 0's JSON figures and the wall."""
    t0 = time.perf_counter()
    torchrun_lm_raw(kind, shape, out_dir, n)
    tag = "x".join(map(str, shape))
    out = json.loads((out_dir / f"{kind}_{tag}.json").read_text())
    out["wall_s"] = time.perf_counter() - t0
    return out


def one_card_smollm(torch, dev):
    """The one-card run the mesh runs are held to: the worker's steps,
    batches and schedule, mesh-less."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_lm_batch
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.train.step import (TrainStepConfig, make_init_fn,
                                        make_train_step)
    cfg = get_config("smollm-135m")
    model = build_model(cfg, dev)
    opt, scfg = AdamW(), TrainStepConfig(learning_rate=LM_MESH_LR)
    state = make_init_fn(model, opt, scfg)(
        torch.Generator(device=dev).manual_seed(0))
    step = make_train_step(model, opt, scfg, cosine_schedule(
        LM_MESH_LR, warmup_steps=LM_MESH_WARMUP, total_steps=LM_MESH_STEPS))
    losses, times = [], []
    for i in range(LM_MESH_STEPS):
        batch = {k: torch.from_numpy(v).long().to(dev) for k, v in
                 synthetic_lm_batch(LAUNCH_B, LAUNCH_S, cfg.vocab_size,
                                    seed=i).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    del model, state, step
    torch.cuda.empty_cache()
    return losses, times


def dsv3_mesh_run(torch, dev, root, shape, predict, card):
    """deepseek-v3-671b cut to DSV3_LAYERS layers on the 4 cards' mesh
    ``shape``: finite losses and grad norms, its MoE layer's routes and
    drops of the first step equal to one card's on the same input and
    router, every rank's local state bytes equal to the dry run's
    (``predict``, a `start_predict` process), its peak beside the dry
    run's.  Returns the figures."""
    import types

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    tag = "x".join(map(str, shape))
    b, s = DSV3_BATCH[shape]
    r = torchrun_lm("dsv3", shape, root, 4)
    require(all(np.isfinite(r["losses"] + r["grad_norms"])),
            f"deepseek-v3 {shape}: a loss or grad norm is not finite: {r}")
    seen = torch.load(root / f"dsv3_{tag}_routes.pt")
    cfg = get_config("deepseek-v3-671b").replace(n_layers=DSV3_LAYERS)
    x = seen["x"].to(dev)
    xt = x.reshape(-1, x.shape[-1])
    rp = types.SimpleNamespace(router=seen["router"].to(dev))
    _, idx, _ = M.route(rp, cfg, xt, s)
    *_, keep = M.dispatch(idx, cfg.moe.n_experts,
                          M.capacity(cfg, xt.shape[0]))
    require(torch.equal(idx.cpu(), seen["idx"])
            and torch.equal(keep.cpu(), seen["keep"]),
            f"deepseek-v3 {shape}: the mesh's routes or drops differ from "
            f"one card's on the same MoE input and router")
    # why the router product runs a sequence at a time: one GEMM over all
    # T rows rounds otherwise and moves these tokens' routes
    _, one_gemm, _ = M.route(rp, cfg, xt)
    moved = int((one_gemm != idx).any(-1).sum())
    xt_rows = xt.shape[0]
    del x, xt, idx, keep, one_gemm
    finish(predict, f"prediction dsv3 {tag}")
    pred = json.loads((root / f"predict_dsv3_{tag}.json").read_text())
    require(all(x == pred["state_bytes_per_device"]
                for x in r["state_bytes_all"]),
            f"deepseek-v3 {shape}: local state bytes {r['state_bytes_all']} "
            f"!= the dry run's {pred['state_bytes_per_device']}")
    step_s = statistics.median(r["step_s"][1:]) if len(r["step_s"]) > 1 \
        else r["step_s"][0]
    pairs = int(seen["keep"].numel())
    f = dict(
        batch=[b, s], losses=r["losses"], grad_norms=r["grad_norms"],
        dropped_pairs=int((~seen["keep"]).sum()), pairs=pairs,
        routes_moved_by_one_gemm=moved,
        global_pairs_gib=pairs * cfg.d_model * 2 / 2 ** 30,
        step_ms=1e3 * step_s, tokens_per_s=r["tokens"] / step_s,
        init_s=r["init_s"],
        moe_forward_gib=r["moe_forward_bytes"] / 2 ** 30,
        peak_gib=[p / 2 ** 30 for p in r["peak_bytes_all"]],
        peak_gib_dryrun=pred["memory"]["peak_bytes_per_device"] / 2 ** 30,
        state_gib=[x / 2 ** 30 for x in r["state_bytes_all"]],
        state_gib_dryrun=pred["state_bytes_per_device"] / 2 ** 30,
        collective_bytes_dryrun=pred["collective_bytes"],
        n_params=pred["n_params"], wall_s=r["wall_s"])
    log(f"  deepseek-v3-671b at full width, {DSV3_LAYERS} layers "
        f"({f['n_params'] / 1e9:.2f} B parameters) on {shape} ({card}), B "
        f"{b} x S {s}: losses {r['losses']}, grad norms {r['grad_norms']} "
        f"finite; routes and {f['dropped_pairs']} of {pairs} pairs "
        f"dropped = one card's on the same MoE input (one GEMM over all "
        f"{xt_rows} rows would move {moved} tokens' routes); "
        f"{f['step_ms']:.0f} ms "
        f"a step ({f['tokens_per_s']:.0f} tokens/s), state "
        f"{max(f['state_gib']):.2f} GiB a card = the dry run's "
        f"{f['state_gib_dryrun']:.2f}, peak {max(f['peak_gib']):.2f} GiB a "
        f"card (dry run {f['peak_gib_dryrun']:.2f}); the MoE layer's "
        f"forward {f['moe_forward_gib']:.2f} GiB above its input on rank 0 "
        f"(the global [T*k, d] pairs {f['global_pairs_gib']:.2f} GiB)")
    return f


def dsv3_prefill_run(torch, dev, root, card):
    """deepseek-v3-671b's bf16 chunked prefill (DSV3_LAYERS layers) on the
    4 cards' mesh of DSV3_PREFILL: finite logits of the right shape; each
    chunk's routes and drops of the first MoE layer equal to one card's on
    the same MoE input and router (chunk by chunk, each with its own
    capacity); the logits beside one card's chunked prefill of the same
    weights and tokens.  Returns the figures."""
    import types

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_lm_batch
    from repro_torch.models import build_model
    from repro_torch.models import moe as M
    shape, b, s = DSV3_PREFILL
    tag = "x".join(map(str, shape))
    t0 = time.perf_counter()
    torchrun_lm_raw("dsv3_prefill", shape, root, 4)
    wall = time.perf_counter() - t0
    seen = torch.load(root / f"dsv3_prefill_{tag}.pt")
    cfg = get_config("deepseek-v3-671b").replace(n_layers=DSV3_LAYERS)
    nc = seen["chunks"]
    require(nc == cfg.prefill_chunks > 1 and len(seen["routes"]) == nc,
            f"deepseek-v3 prefill {tag}: {len(seen['routes'])} route sets "
            f"for {cfg.prefill_chunks} chunks")
    logits = seen["logits"]
    require(tuple(logits.shape) == (b, 1, cfg.vocab_size)
            and bool(torch.isfinite(logits).all()),
            f"deepseek-v3 prefill {tag}: logits {tuple(logits.shape)} not "
            f"finite or of a wrong shape")
    rp = types.SimpleNamespace(router=seen["router"].to(dev))
    x = seen["x"].to(dev)
    rows, dropped = b // nc, 0
    for c, (want_idx, want_keep) in enumerate(seen["routes"]):
        xt = x[c * rows:(c + 1) * rows].reshape(-1, x.shape[-1])
        _, idx, _ = M.route(rp, cfg, xt, s)
        *_, keep = M.dispatch(idx, cfg.moe.n_experts,
                              M.capacity(cfg, xt.shape[0]))
        require(torch.equal(idx.cpu(), want_idx)
                and torch.equal(keep.cpu(), want_keep),
                f"deepseek-v3 prefill {tag}: chunk {c}'s routes or drops "
                f"differ from one card's on the same MoE input and router")
        dropped += int((~want_keep).sum())
    pairs = sum(int(k.numel()) for _, k in seen["routes"])
    del x, rp
    # one card's chunked prefill of the same weights and tokens
    model = build_model(cfg, dev).init(
        torch.Generator(device=dev).manual_seed(0))
    tokens = torch.from_numpy(synthetic_lm_batch(
        b, s, cfg.vocab_size, seed=0)["tokens"]).long().to(dev)
    one, _ = model.prefill({"tokens": tokens})
    diff = max_abs(logits.to(dev), one.float())
    del model, one
    torch.cuda.empty_cache()
    f = dict(mesh=list(shape), batch=[b, s], chunks=nc, pairs=pairs,
             dropped_pairs=dropped, prefill_ms=1e3 * seen["prefill_s"][-1],
             peak_gib=seen["peak_bytes"] / 2 ** 30,
             max_abs_logit_diff_one_card=diff, wall_s=wall)
    log(f"  deepseek-v3-671b prefill, {DSV3_LAYERS} layers in bf16 on {tag} "
        f"({card}), B {b} x S {s} in {nc} chunks: every chunk's routes and "
        f"{dropped} of {pairs} pairs dropped = one card's on the same MoE "
        f"input (each chunk at its own capacity); logits finite, within "
        f"{diff:.4g} of one card's chunked prefill (bf16, not gated); "
        f"{f['prefill_ms']:.1f} ms, peak {f['peak_gib']:.2f} GiB on rank 0")
    return f


def lm_mesh_phase(torch, dev, n_cards):
    """``--mesh-cards``: the LM on a mesh of 4 cards (see the constants
    above).  Returns the figures."""
    import shutil

    import numpy as np

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    require(n_cards >= 4, "the LM mesh runs need 4 cards")
    root = ROOT / "build" / "chip_lm_mesh"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    preds = {tag: start_predict(root / f"predict_{tag}.json", arch, shape,
                                b, s, layers)
             for tag, arch, shape, b, s, layers in (
                 ("smollm_4x1", "smollm-135m", (4, 1), LAUNCH_B, LAUNCH_S, 0),
                 ("smollm_2x2", "smollm-135m", (2, 2), LAUNCH_B, LAUNCH_S, 0),
                 ("dsv3_1x4", "deepseek-v3-671b", (1, 4),
                  *DSV3_BATCH[(1, 4)], DSV3_LAYERS),
                 ("dsv3_2x2", "deepseek-v3-671b", (2, 2),
                  *DSV3_BATCH[(2, 2)], DSV3_LAYERS))}
    one, one_times = one_card_smollm(torch, dev)
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    card = f"{len(cards)} x {cards[0]}"
    figures = {"cards": cards, "one_card": dict(
        losses=one, step_ms=1e3 * statistics.median(one_times[1:]))}
    for shape in ((4, 1), (2, 2)):
        r = torchrun_lm("smollm", shape, root, 4)
        tag = "x".join(map(str, shape))
        diff = max(abs(a - b) for a, b in zip(r["losses"], one))
        require(diff <= LM_MESH_TOL, f"smollm {tag}: losses differ from one "
                f"card by {diff} > {LM_MESH_TOL}")
        require(np.mean(r["losses"][-5:]) < np.mean(r["losses"][:5]),
                f"smollm {tag}: the loss did not fall")
        finish(preds[f"smollm_{tag}"], f"prediction {tag}")
        pred = json.loads((root / f"predict_smollm_{tag}.json").read_text())
        require(all(x == pred["state_bytes_per_device"]
                    for x in r["state_bytes_all"]),
                f"smollm {tag}: local state bytes {r['state_bytes_all']} != "
                f"the dry run's {pred['state_bytes_per_device']}")
        step_s = statistics.median(r["step_s"][1:])
        figures[f"smollm_{tag}"] = dict(
            losses=r["losses"], max_loss_diff=diff,
            step_ms=1e3 * step_s, tokens_per_s=r["tokens"] / step_s,
            peak_gib=[p / 2 ** 30 for p in r["peak_bytes_all"]],
            peak_gib_dryrun=pred["memory"]["peak_bytes_per_device"] / 2 ** 30,
            state_bytes=r["state_bytes_all"][0], wall_s=r["wall_s"])
        f = figures[f"smollm_{tag}"]
        log(f"  smollm-135m on {tag} ({card}; {LM_MESH_STEPS} steps, B "
            f"{LAUNCH_B} x S {LAUNCH_S}): losses within {diff:.4g} of one "
            f"card (before: {SMOLLM_GAPS_BEFORE[tag]:.4g}), "
            f"{f['step_ms']:.1f} ms a step ({f['tokens_per_s']:.0f} tokens/s;"
            f" one card {figures['one_card']['step_ms']:.1f} ms), peak "
            f"{max(f['peak_gib']):.2f} GiB a card (dry run "
            f"{f['peak_gib_dryrun']:.2f}), local state "
            f"{f['state_bytes']} bytes = the dry run's")
    figures["smollm_2x2"]["restored_leaves"] = r["restored_leaves"]
    ck = CheckpointManager(root / "ckpt_4x1")
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW
    model = build_model(get_config("smollm-135m"), dev)
    params = dict(model.named_parameters())
    target = {"params": params, "opt": AdamW().init(params),
              "step": torch.zeros((), dtype=torch.int32, device=dev)}
    restored, _ = ck.restore(target)
    z = np.load(ck.root / f"step_{LM_MESH_STEPS:010d}" / "tensors.npz")
    from repro_torch.checkpoint import flatten_state
    for k, t in flatten_state(restored):
        got = t.detach().cpu()
        got = (got.view(torch.int16).numpy() if got.dtype == torch.bfloat16
               else got.numpy())
        want = z[k].view(np.int16) if z[k].dtype.kind == "V" else z[k]
        require(np.array_equal(got, want), f"restore (4, 1) -> one card: {k}")
    del model, params, target, restored
    torch.cuda.empty_cache()
    log(f"  a checkpoint saved on (4, 1) restores on (2, 2) and on one card "
        f"bitwise ({len(z.files)} leaves)")

    for shape in DSV3_BATCH:
        tag = "x".join(map(str, shape))
        figures[f"dsv3_{tag}"] = dsv3_mesh_run(torch, dev, root, shape,
                                               preds[f"dsv3_{tag}"], card)
    figures["dsv3_prefill"] = dsv3_prefill_run(torch, dev, root, card)
    shutil.rmtree(root, ignore_errors=True)
    return figures



def mesh_cards_main(n_cards: int) -> int:
    """``--mesh-cards N``: the build, the data mesh on ``data_mesh(m)`` for
    m in 1, 2, 4 up to N (`mesh_phase`), Table 1 per card count
    (`mesh_table1`), and the closing lines.  Fails on a host with fewer
    than N cards."""
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout (src/repro_torch "
              "not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    LOG_FILE.parent.mkdir(exist_ok=True)
    _log_file.append(open(LOG_FILE.with_name("chip_smoke_mesh.log"), "w"))
    if torch.cuda.device_count() < n_cards:
        print(f"chip_smoke: --mesh-cards {n_cards} needs {n_cards} cards, "
              f"this host has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    fresh_dispatch_cache("chip_smoke_mesh_dispatch.json")
    import numpy as np

    from repro_torch.configs.difet_paper import DifetConfig
    from repro_torch.core.bundle import tile_scene
    from repro_torch.data.landsat import synthetic_scene
    from repro_torch.distributed import data_mesh
    from repro_torch.kernels import build
    from repro_torch.launch import stitch

    dev = torch.device("cuda", 0)
    log("torch", torch.__version__, "cuda", torch.version.cuda, "devices",
        [torch.cuda.get_device_name(i)
         for i in range(torch.cuda.device_count())])
    t0 = time.perf_counter()
    build_phase(build)
    log(f"phase 1 (build): {time.perf_counter() - t0:.1f} s")
    cfg = DifetConfig()
    cfg256 = DifetConfig(tile=256, halo=24, max_keypoints_per_tile=256)
    scene = synthetic_scene(*cfg.scene_hw, seed=0)
    bundle, bundle256 = tile_scene(scene, cfg), tile_scene(scene, cfg256)
    del scene
    stitch_store = ROOT / "build" / "chip_smoke_mesh_stitch"
    import shutil
    shutil.rmtree(stitch_store, ignore_errors=True)
    stitch.main(STITCH_ARGS + ["--store", str(stitch_store), "--mesh",
                               "none"], device=dev)
    meshes = [data_mesh(m) for m in (1, 2, 4) if m < n_cards]
    meshes.append(data_mesh(n_cards))
    t0 = time.perf_counter()
    log(f"data mesh on {[m.size for m in meshes]} card(s):")
    figures = mesh_phase(torch, np, dev, meshes, bundle, bundle256,
                         stitch_store)
    (figures["table1_s"], figures["table1_split_s"],
     figures["table1_counts"]) = mesh_table1(torch, dev, meshes, cfg)
    t1 = figures["table1_s"]
    for m in meshes:
        if m.size > 1:
            log(f"  Table 1 speedup on {m.size} cards over the one-device "
                f"sweep (one worker): " + ", ".join(
                    f"{alg} {t1['one_device'][alg] / t:.3f}x"
                    for alg, t in t1[f"cards_{m.size}"].items())
                + "; the reference's gate "
                "(benchmarks/table1_scalability.py:31) is sift >= 1.6x at 2 "
                "workers")
    log(f"phase 3f (data mesh, {n_cards} cards): "
        f"{time.perf_counter() - t0:.1f} s")
    shutil.rmtree(stitch_store, ignore_errors=True)
    t0 = time.perf_counter()
    log(f"the LM on a mesh of {n_cards} cards (torchrun workers):")
    lm_figures = lm_mesh_phase(torch, dev, n_cards)
    log(f"LM mesh runs: {time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    for line in smi.stdout.strip().splitlines():
        log("card: " + line)
    print("mesh " + json.dumps(figures))
    print("lm_mesh " + json.dumps(lm_figures))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main(select_only: bool = False) -> int:
    """The whole run; ``select_only`` (``--select``): the build and the
    selection kernel's rows (`select_phase`) alone."""
    # phase 3h runs in torch's deterministic mode, whose cuBLAS calls need
    # this workspace setting in place before the process's first GEMM
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout (src/repro_torch "
              "not found)", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    LOG_FILE.parent.mkdir(exist_ok=True)
    _log_file.append(open(LOG_FILE, "w"))
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs.difet_paper import DifetConfig, PAPER_ALGORITHMS
    from repro_torch.core import descriptors as DS
    from repro_torch.core import engine
    from repro_torch.core.bundle import tile_scene
    from repro_torch.core.padding import reflect_pad
    from repro_torch.core.pyramid import (
        downsample2, f32, fused_octave_response, gaussian_kernel_1d,
        octave_increments)
    from repro_torch.data.landsat import synthetic_scene
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import scalespace as SS

    # the port runs no matmul or convolution; the conv2d yardstick below is
    # held to full fp32 as well
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0))
    phase_start = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        log(f"phase {name}: {now - phase_start[0]:.1f} s")
        phase_start[0] = now

    # ---- 1. build -----------------------------------------------------------
    build_phase(build)
    phase_done("1 (build)")

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
    if select_only:
        cfg256 = DifetConfig(tile=256, halo=24, max_keypoints_per_tile=256)
        bundle256 = tile_scene(scene, cfg256)
        select_phase(torch, np, dev, (
            ("paper", cfg, tiles, headers),
            ("sift-t256", cfg256, torch.from_numpy(bundle256.tiles).to(dev),
             torch.from_numpy(bundle256.headers).to(dev))))
        phase_done("2 (the selection kernel)")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # ---- 2. each kernel against its plain twin ------------------------------
    err = {k: 0.0 for k in ops.KERNELS}
    rng = np.random.RandomState(0)

    def hold(name, got, want, rtol, atol, thr=None, bitwise=False):
        torch.cuda.synchronize()
        require(got.shape == want.shape, f"{name}: shape {tuple(got.shape)}")
        e = (got - want).abs().max().item() if got.numel() else 0.0
        same = torch.equal(got, want)
        ok = same if bitwise else torch.allclose(got, want, rtol=rtol,
                                                 atol=atol)
        same_mask = thr is None or torch.equal(got > thr, want > thr)
        gate = "bitwise" if bitwise else f"rtol {rtol:g} atol {atol:g}"
        log(f"  {name:34s} {str(tuple(got.shape)):18s} max|err| {e:.3g} "
            f"bitwise {same} (gate: {gate})")
        require(ok and same_mask, f"{name}: kernel disagrees with its twin")
        return e

    def sigma_for_radius(r):
        """A sigma whose window radius ceil(3 sigma) is r."""
        s = (r - 0.5) / 3
        require((len(gaussian_kernel_1d(s)) - 1) // 2 == r, f"radius {r}")
        return s

    def rand(*shape):
        return torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(dev)

    log("kernels vs plain twins on the card (blur, harris, fast and "
        "scalespace bitwise):")
    x = tiles
    odd = rand(3, 61, 200)
    # the kernels stage with 16-byte copies only where W % 4 == 0 and the
    # data pointer is 16-byte aligned: the tiles do; these two take the
    # scalar reflecting staging
    odd_r = rand(3, 97, 131)                 # W % 4 != 0
    buf = rand(1 + 2 * 560 * 560)
    misaligned = buf[1:].view(2, 560, 560)   # one float into a buffer
    require(x.data_ptr() % 16 == 0 and misaligned.data_ptr() % 16 == 4,
            "the tiles must be 16-byte aligned and the view 4 bytes off")
    harris_cases = [(x, 1.0, "tiles"), (odd, 1.0, "odd"),
                    (rand(1, 560, 560), 1.0, "N=1"),
                    (misaligned, 1.0, "misaligned view"),
                    (rand(2, 3, 3), 1.0, "3^2"), (rand(2, 3, 3), 3.2, "3^2")]
    harris_cases += [(odd_r, sigma_for_radius(r), f"r={r}")
                     for r in range(1, 17)]
    for img, sigma, tag in harris_cases:
        for shi in (False, True):
            e = hold(f"harris shi={shi} s={sigma:.3f} {tag}",
                     ops.harris(img, k=cfg.harris_k, sigma=sigma,
                                shi_tomasi=shi),
                     ref.harris(img, k=cfg.harris_k, sigma=sigma,
                                shi_tomasi=shi),
                     0, 0, bitwise=True)
            err["harris"] = max(err["harris"], e)
    # FAST: the scene's threshold and the stitch's (launch/stitch.py), noise
    # (most pixels pass the compass pre-test) and a constant image (none
    # does), the scalar staging, N = 1, images smaller than the pad of 3,
    # and every arc (m = arc // 4 from 0 to 4) at three thresholds
    noise = rand(*x.shape)
    fast_cases = [(x, cfg.fast_threshold, cfg.fast_arc, "tiles"),
                  (x, STITCH_FAST_THRESHOLD, cfg.fast_arc, "tiles"),
                  (noise, cfg.fast_threshold, cfg.fast_arc, "uniform noise"),
                  (torch.full((2, 100, 100), 0.5, device=dev),
                   cfg.fast_threshold, cfg.fast_arc, "constant"),
                  (odd, cfg.fast_threshold, cfg.fast_arc, "odd"),
                  (odd_r, cfg.fast_threshold, cfg.fast_arc, "odd_r"),
                  (misaligned, cfg.fast_threshold, cfg.fast_arc,
                   "misaligned view"),
                  (rand(1, 560, 560), cfg.fast_threshold, cfg.fast_arc,
                   "N=1")]
    fast_cases += [(rand(2, hh, ww), 0.0, cfg.fast_arc, f"{hh}x{ww} < pad")
                   for hh, ww in ((3, 3), (2, 2), (1, 7))]
    fast_cases += [(odd_r, t, arc, f"odd_r arc {arc}") for arc in range(1, 17)
                   for t in (0.0, 0.05, 0.15)]
    for img, t, arc, tag in fast_cases:
        e = hold(f"fast t={t:g} {tag}" + ("" if "arc" in tag
                                          else f" arc {arc}"),
                 ops.fast_score(img, threshold=t, arc=arc),
                 ref.fast_score(img, threshold=t, arc=arc), 0, 0,
                 bitwise=True)
        err["fast"] = max(err["fast"], e)
    del fast_cases
    base0 = ops.gaussian_blur(x, 1.6)
    kp_shape = (x.shape[0], cfg.max_keypoints_per_tile)
    ys = torch.from_numpy(rng.randint(24, 536, kp_shape)).to(dev)
    xs = torch.from_numpy(rng.randint(24, 536, kp_shape)).to(dev)
    patches = DS.extract_patches(x, ys, xs, 22).reshape(-1, 22, 22)
    incs = octave_increments(cfg.scales_per_octave, 1.6)
    blur_cases = [(x, 1.6, "tiles s0"), (x, 2.0, "tiles desc"),
                  (patches, 1.0, "patches"), (odd, 3.2, "odd"),
                  (patches[:1001], 1.0, "1001 patches"),
                  (rand(2, 5, 7), 3.2, "5x7 < r"),
                  (rand(2, 5, 100), 3.2, "5 rows < r, tiled"),
                  (rand(1, 560, 560), 1.6, "N=1"),
                  (misaligned, 1.6, "misaligned view"),
                  (misaligned, incs[-1], "misaligned view")]
    blur_cases += [(base0, s, f"octave0 inc{i}") for i, s in enumerate(incs, 1)]
    blur_cases += [(odd_r, sigma_for_radius(r), f"r={r}") for r in range(1, 17)]
    for img, sigma, tag in blur_cases:
        e = hold(f"blur s={sigma:.3f} {tag}", ops.gaussian_blur(img, sigma),
                 ref.gaussian_blur(img, sigma), 0, 0, bitwise=True)
        err["blur"] = max(err["blur"], e)
    del odd_r, buf, misaligned
    thr = cfg.sift_contrast_threshold / cfg.scales_per_octave
    # the scale-space octave, bit for bit: 304^2 (octave 0 at tile 256, the
    # path that runs the kernel), the higher octaves of a 560^2 tile (280,
    # 140, 70), a 10^2 octave smaller than its pad, an odd width, two other
    # octaves (other radii; spo 6 at sigma0 3.6 lets one block on an SM) at
    # 81 x 200 and 304^2, N = 1, a view one float into a buffer, and a width
    # one column past the default strip (two strips, evened out)
    cfg256 = DifetConfig(tile=256, halo=24, max_keypoints_per_tile=256)
    bundle256 = tile_scene(scene, cfg256)
    tiles256 = torch.from_numpy(bundle256.tiles).to(dev)
    headers256 = torch.from_numpy(bundle256.headers).to(dev)
    require(tiles256.shape == (961, 304, 304), "the scene must cut into "
            "961 tiles of 304^2 at tile 256")
    base304 = ops.gaussian_blur(tiles256[:128], 1.6)
    ss_radii = [(len(gaussian_kernel_1d(s)) - 1) // 2 for s in incs]
    ss_wt = SS.geometry(3, 1.6, 304)[0]
    one_block = SS.geometry(6, 3.6, 304)
    log(f"  scalespace geometry of spo 6 at sigma0 3.6, 304 wide: strip "
        f"{one_block[0]}, {one_block[1]} B a block, {one_block[2]} block(s) "
        f"per SM")
    require(one_block[2] == 1, "spo 6 at sigma0 3.6 must take the kernel's "
            "one-block layout")
    n_octaves = 0
    for spo in range(1, 7):
        for s0 in np.arange(0.3, 6.0, 0.01):
            try:
                SS.octave_taps(spo, float(s0))
            except ValueError:
                continue                       # beyond the kernel's limits
            for w in (10, 304):
                require(SS.geometry(spo, float(s0), w)[2] >= 1,
                        f"spo {spo} sigma0 {s0:.2f} does not fit an SM")
            n_octaves += 1
    log(f"  scalespace geometry: all {n_octaves} octaves the wrapper accepts "
        f"(spo 1-6, sigma0 0.3-6 by 0.01) get a strip at widths 10 and 304")
    octave_bases = []
    base = ref.gaussian_blur(x, 1.6)
    for _ in range(3):
        _, seed = fused_octave_response(base, 3, thr)
        base = downsample2(seed)
        octave_bases.append(base)                   # 280^2, 140^2, 70^2
    ss_buf = torch.empty(1 + 2 * 304 * 304, device=dev)
    ss_view = ss_buf[1:].view(2, 304, 304)
    ss_view.copy_(base304[:2])
    require(ss_view.data_ptr() % 16 == 4, "the view must be 4 bytes off")
    ss_cases = [(base304, 3, 1.6, "304^2"),
                *[(b, 3, 1.6, f"{b.shape[-1]}^2") for b in octave_bases],
                (octave_bases[-1][:4, :10, :10].contiguous(), 3, 1.6, "10^2"),
                (ref.gaussian_blur(odd[:, :, :199].contiguous(), 1.6), 3, 1.6,
                 "odd width 199"),
                (base304[:1], 3, 1.6, "N=1"),
                (ss_view, 3, 1.6, "misaligned view"),
                (base304[:4, :, :ss_wt + 1].contiguous(), 3, 1.6,
                 f"width {ss_wt + 1}")]
    for spo, s0 in ((2, 1.6), (3, 1.2), (6, 3.6)):
        ss_cases += [(ref.gaussian_blur(rand(4, 81, 200), s0), spo, s0,
                      "81x200"),
                     (ref.gaussian_blur(tiles256[:16], s0), spo, s0, "304^2")]
    for b, spo, s0, tag in ss_cases:
        kw = dict(scales_per_octave=spo, contrast_threshold=thr, sigma0=s0)
        got = ops.scalespace_octave(b, **kw)
        want = ref.scalespace_octave(b, **kw)
        tag = f"{tag} spo {spo} s0 {s0}"
        err["scalespace"] = max(
            err["scalespace"],
            hold(f"scalespace resp {tag}", got[0], want[0], 0, 0, thr=thr,
                 bitwise=True),
            hold(f"scalespace seed {tag}", got[1], want[1], 0, 0,
                 bitwise=True))
    del got, want, octave_bases, ss_cases, ss_buf, ss_view
    torch.cuda.synchronize()
    err["matcher"] = check_matcher(torch, np, dev)
    select_rows, select_total = select_phase(
        torch, np, dev, (("paper", cfg, x, headers),
                         ("sift-t256", cfg256, tiles256, headers256)))
    err["select"] = 0.0

    phase_done("2 (kernels against their twins)")

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
    for name in MAIN_KERNELS:
        require(launches[name] >= 1,
                f"kernel {name} was not launched on the main path")
    # octave 0 of a 560^2 tile runs per level (the reference's rule) and no
    # result reads octaves 1-3, so the fused octave has no work here
    require(launches["scalespace"] == 0,
            "the scale-space kernel ran on the tile-512 path, whose fused "
            "octaves no result reads")

    res_k2 = run(True)
    for alg in PAPER_ALGORITHMS:
        for key, v in res_k[alg].items():
            require(torch.equal(v, res_k2[alg][key]),
                    f"two kernel-route runs differ in {alg}/{key}")
    log("  two kernel-route runs: bitwise identical")

    res_p = run(False)
    torch.cuda.synchronize()
    counts = {alg: same_routes(alg, res_k[alg], res_p[alg],
                               cfg.max_keypoints_per_tile)
              for alg in PAPER_ALGORITHMS}
    log("  plain route agrees: counts, keypoints, valid flags and packed "
        "bits equal; scores and float descriptors within 1e-5")
    log("table2_counts " + json.dumps(counts))
    reference = json.loads(REFERENCE_COUNTS.read_text())
    for alg in PAPER_ALGORITHMS:
        for route, res in (("kernel", res_k), ("plain", res_p)):
            against_reference(f"{alg} ({route} route)",
                              res[alg]["per_tile_count"].tolist(),
                              {mode: reference["tile512"][mode][alg]
                               for mode in ("fma", "no_fma")})
    # the exact fields tile by tile: the map's output (the function
    # extract_features_multi reduces) and the reduce's, each route
    for use, res in ((True, res_k), (False, res_p)):
        per = engine.extract_tile_multi(PAPER_ALGORITHMS, cfg, tiles,
                                        headers.to(torch.int32),
                                        use_kernels=use)
        for alg in PAPER_ALGORITHMS:
            against_digests(f"{alg} ({'kernel' if use else 'plain'} route)",
                            alg, per[alg],
                            {mode: reference["tile512"][mode][alg]
                             for mode in ("fma", "no_fma")}, res[alg])
        del per
    scene_counts = {alg: res_k[alg]["per_tile_count"].tolist()
                    for alg in PAPER_ALGORITHMS}
    del res_k2, res_p
    # the reference's level-by-level SIFT baseline with kernels (a blur
    # launch a level, the 26 neighbours stacked) against the engine's
    # route, octave 0 of QUARTER tiles: the same operations, bitwise
    from repro_torch.core import detectors as D
    sift_thr = cfg.sift_contrast_threshold / cfg.scales_per_octave

    def sift_fused():
        return D.sift_dog_response(tiles[:QUARTER], 1, cfg.scales_per_octave,
                                   sift_thr, use_kernels=True)[0]

    def sift_levelwise():
        return D.sift_dog_response_levelwise(
            tiles[:QUARTER], 1, cfg.scales_per_octave, sift_thr,
            use_kernels=True)[0]
    require(torch.equal(sift_levelwise(), sift_fused()),
            "sift_dog_response_levelwise (kernels) differs from the fused "
            "route")
    log(f"  sift_dog_response_levelwise with kernels = the engine's route "
        f"bitwise on {QUARTER} tiles (octave 0): {cuda_ms(sift_levelwise):.3f}"
        f" ms against {cuda_ms(sift_fused):.3f} ms")

    phase_done("3 (main path)")

    # ---- 3a. the scale-space kernel's own path: SIFT at tile 256 ------------
    # the reference's launch/extract.py defaults (tile 256, halo 24, K 256):
    # octave 0 of a 304^2 tile fuses, so the fused octave runs once
    def run256():
        return engine.extract_features_multi(
            tiles256, headers256, ("sift",), cfg256, device=dev)["sift"]

    log(f"scale-space path: extract_features_multi, sift, "
        f"{tiles256.shape[0]} tiles of {tiles256.shape[1]}^2 at once")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res256 = run256()
    torch.cuda.synchronize()
    t256_first = time.perf_counter() - t0
    launches256 = ops.launch_counts()
    require(launches256["scalespace"] >= 1 and launches256["blur"] >= 1,
            "the fused octave or the base blur did not run at tile 256")
    res256b = run256()
    for key, v in res256.items():
        require(torch.equal(v, res256b[key]),
                f"two tile-256 sift runs differ in {key}")
    require(bool(torch.isfinite(res256["top_scores"]).all())
            and res256["top_ys"].shape == (4 * cfg256.max_keypoints_per_tile,)
            and int(res256["total_count"]) > 0,
            "tile-256 sift: scores not finite, a wrong top-K shape or no "
            "keypoint")
    t256 = host_s(run256, REPS)
    log(f"  launches {launches256}; two runs bitwise identical; sift count "
        f"{int(res256['total_count'])}; first run {t256_first:.3f} s, "
        f"median of {REPS} {t256:.4f} s")
    whole_run = res256["per_tile_count"].tolist()
    whole_top = {k: res256[k] for k in ("top_ys", "top_xs", "top_valid")}
    del res256, res256b
    # both routes on all tiles, QUARTER at a time (the plain route holds a
    # 26-neighbour stack of its whole batch); where a chunk's per-tile
    # counts agree across the routes, so must its keypoints
    t0 = time.perf_counter()
    per_route = {True: [], False: []}
    fields256 = {True: [], False: []}
    split, same_chunks = [], 0
    # chunks of QUARTER tiles, the last one taking the remainder (a chunk
    # of fewer than 4 tiles would cut the global top-K shorter)
    bounds = list(range(0, tiles256.shape[0] - QUARTER, QUARTER))
    for i, j in zip(bounds, bounds[1:] + [tiles256.shape[0]]):
        sub = {use: engine.extract_features_multi(
            tiles256[i:j], headers256[i:j], ("sift",),
            cfg256, use_kernels=use, device=dev)["sift"]
            for use in (True, False)}
        c = {use: r["per_tile_count"].tolist() for use, r in sub.items()}
        for use in (True, False):
            per_route[use] += c[use]
            mapped = engine.extract_tile_multi(
                ("sift",), cfg256, tiles256[i:j],
                headers256[i:j].to(torch.int32), use_kernels=use)["sift"]
            fields256[use].append({f: mapped[f] for f in ("ys", "xs",
                                                          "valid")})
        split += [(i + k, a, b) for k, (a, b) in
                  enumerate(zip(c[True], c[False])) if a != b]
        if c[True] == c[False]:
            same_routes("sift (tile 256)", sub[True], sub[False],
                        cfg256.max_keypoints_per_tile)
            same_chunks += 1
    require(per_route[True] == whole_run, "tile-256 sift: the chunked kernel "
            "route's per-tile counts differ from the whole run's")
    log(f"  all {len(whole_run)} tiles, {QUARTER} at a time "
        f"({time.perf_counter() - t0:.1f} s): {len(split)} tile(s) where "
        f"the kernel and plain routes' counts differ "
        f"(tile, kernel, plain): {split}; keypoints, valid flags, scores and "
        f"descriptors of the {same_chunks} chunk(s) with equal counts equal")
    for use, key in ((True, "use_pallas=True"), (False, "use_pallas=False")):
        modes = {mode: reference["tile256"][mode][key]
                 for mode in ("fma", "no_fma")}
        tag = (f"sift tile 256 ({'kernel' if use else 'plain'} route vs the "
               f"reference's {key})")
        against_reference(tag, per_route[use], modes)
        # the kernel route's reduce is the whole run's; the plain route
        # runs in chunks only
        per = {f: torch.cat([r[f] for r in fields256[use]])
               for f in ("ys", "xs", "valid")}
        against_digests(tag, "sift", per, modes, whole_top if use else None)
    del sub, per_route, fields256, per

    phase_done("3a (tile-256 SIFT)")

    # ---- 3b. the matching path ----------------------------------------------
    # two overlapping crops of the paper's size from one wide scene; scene
    # b's origin sits at PAIR_OFFSET in scene a, so t = -PAIR_OFFSET
    import shutil
    from repro_torch.core import matching
    from repro_torch.launch import stitch
    dy, dx = PAIR_OFFSET
    t0 = time.perf_counter()
    wide = synthetic_scene(cfg.scene_hw[0] + dy, cfg.scene_hw[1] + dx, seed=1)
    crops = [wide[:cfg.scene_hw[0], :cfg.scene_hw[1]],
             wide[dy:, dx:]]
    pair_bundles = [tile_scene(np.ascontiguousarray(c), cfg) for c in crops]
    del wide, crops
    log(f"matching path: two {cfg.scene_hw} crops at offset {PAIR_OFFSET}, "
        f"{len(pair_bundles[0])} tiles each, set-up "
        f"{time.perf_counter() - t0:.1f} s")
    match_algs = ("sift", "surf", "brief", "orb")
    # the measured dispatch's verdicts for every bucket the path reaches (the
    # shapes of the pair's own top-K lists), on this card, before the
    # counters go to 0: the path then measures nothing
    feats = [engine.extract_features_multi(b.tiles, b.headers, match_algs,
                                           cfg, device=dev)
             for b in pair_bundles]
    verdicts = dispatch_step(torch, ops, feats, match_algs)
    del feats
    # keep the inputs and path of every kernel call the path makes, so that
    # phase 4 times the path's matcher launches one by one
    from repro_torch.kernels import dispatch
    match_calls = []
    path_fns = {name: ops._PATH_FNS[name] for name in dispatch.CUDA_PATHS}

    def recorder(name, fn):
        def recorded(q, db, db_valid, *, metric):
            match_calls.append((q, db, db_valid, metric, name))
            return fn(q, db, db_valid, metric=metric)
        return recorded

    ops._PATH_FNS.update({n: recorder(n, f) for n, f in path_fns.items()})
    torch.cuda.synchronize()
    measured = dispatch.measure_count
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    feats = [engine.extract_features_multi(b.tiles, b.headers, match_algs,
                                           cfg, device=dev)
             for b in pair_bundles]
    torch.cuda.synchronize()
    t_extract = time.perf_counter() - t0
    t0 = time.perf_counter()
    reg_k = register_all(torch, matching, feats, match_algs, None)
    t_register_first = time.perf_counter() - t0
    store = ROOT / "build" / "chip_smoke_stitch"
    shutil.rmtree(store, ignore_errors=True)
    t0 = time.perf_counter()
    st1 = stitch.main(STITCH_ARGS + ["--store", str(store)], device=dev)
    t_stitch = time.perf_counter() - t0
    torch.cuda.synchronize()
    match_launches = ops.launch_counts()
    ops._PATH_FNS.update(path_fns)
    log(f"  matching path launches {match_launches}; kernel calls by path "
        f"{dict(collections.Counter(c[4] for c in match_calls))}")
    require(len(match_calls) == match_launches["matcher"],
            f"{len(match_calls)} matcher calls recorded for "
            f"{match_launches['matcher']} launches")
    require(dispatch.measure_count == measured,
            "the matching path measured a bucket the dispatch step did not: "
            f"{sorted(set(dispatch.explain()) - set(verdicts))}")
    for name in MATCH_KERNELS + ("fast", "blur"):
        require(match_launches[name] >= 1,
                f"kernel {name} was not launched on the matching path")

    reg_p = register_all(torch, matching, feats, match_algs, False)
    reg_c = register_all(torch, matching, feats, match_algs, True)
    t0 = time.perf_counter()
    register_all(torch, matching, feats, match_algs, None)
    t_register = time.perf_counter() - t0
    want_t = torch.tensor([-dy, -dx], dtype=torch.float32, device=dev)
    for alg in match_algs:
        (mk, ek), (mp, ep) = reg_k[alg], reg_p[alg]
        # the measured route against the plain route and the kernels' route
        for (mo, eo), other in ((reg_p[alg], "plain"),
                                (reg_c[alg], "use_kernels=True")):
            what = f"{alg}: measured route vs {other} route"
            require(torch.equal(mk.ok, mo.ok), f"{what}: ok differs")
            same = mk.idx_b == mo.idx_b
            require(bool(same[mk.ok].all()), f"{what}: a matched idx_b "
                    "differs")
            if alg in ("brief", "orb"):
                require(bool(same.all()), f"{what}: idx_b differs")
            require(bool((ek.t - eo.t).abs().max() <= 1e-3),
                    f"{what}: t differs beyond 1e-3")
        same_idx = mk.idx_b == mp.idx_b
        require(bool(torch.isfinite(ek.t).all()), f"{alg}: t not finite")
        e = float((ek.t - want_t).abs().max())
        log(f"  {alg:5s} matches {int(mk.ok.sum()):5d}, inliers "
            f"{int(ek.n_inliers):5d}, t ({float(ek.t[0]):+.3f}, "
            f"{float(ek.t[1]):+.3f}), |t - truth| {e:.3f} px, rms "
            f"{float(ek.rms):.3f}; plain route: equal ok, idx_b equal at "
            f"{int(same_idx.sum())}/{same_idx.numel()}, |dt| "
            f"{float((ek.t - ep.t).abs().max()):.2g}; use_kernels=True: "
            f"|dt| {float((ek.t - reg_c[alg][1].t).abs().max()):.2g}")
        if alg == "orb":
            require(e <= 1.0 and int(ek.n_inliers) >= 8,
                    "orb must recover the offset within 1 px with >= 8 "
                    "inliers")
    require(st1["max_err"] is not None and st1["max_err"] <= 1.0,
            f"stitch max_err {st1['max_err']}")
    require(len(st1["positions"]) == 4 and not st1["dropped"],
            "stitch must place all 4 scenes and drop no pair")
    t0 = time.perf_counter()
    st2 = stitch.main(STITCH_ARGS + ["--store", str(store)], device=dev)
    t_resume = time.perf_counter() - t0
    require(st2["positions"] == st1["positions"]
            and st2["pairs"] == st1["pairs"], "the resumed stitch differs")
    log(f"  stitch: 4 scenes placed, max_err {st1['max_err']:.3f} px, "
        f"resume identical; wall {t_stitch:.2f} s (store build, extraction, "
        f"matching), resume {t_resume:.2f} s")
    log(f"  wall: extraction of both crops (4 algorithms) {t_extract:.3f} s; "
        f"register_pair x4 algorithms {t_register:.3f} s "
        f"(first call {t_register_first:.3f} s)")
    del feats, reg_k, reg_p, reg_c, pair_bundles

    phase_done("3b (matching and stitch)")

    # ---- 3c. streamed ingest, the Table-1 sweep, the extraction driver -----
    from repro_torch.core.bundle import BundleStore, TileBundle
    from repro_torch.data import pipeline
    from repro_torch.data.landsat import BandSceneReader, write_scene_bands
    from repro_torch.launch import extract as extract_cli
    from repro_torch.launch import scale

    # 1. the paper scene as one float32 gray band on disk, streamed at
    # DifetConfig() in batches of BATCH_TILES tiles
    ingest_dir = ROOT / "build" / "chip_smoke_ingest"
    shutil.rmtree(ingest_dir, ignore_errors=True)
    t0 = time.perf_counter()
    reader = BandSceneReader(write_scene_bands(ingest_dir, "paper", scene))
    log(f"streamed ingest: the paper scene {reader.shape} written as one "
        f"float32 gray band in {time.perf_counter() - t0:.2f} s; batches of "
        f"{BATCH_TILES} tiles at tile {cfg.tile}, halo {cfg.halo}")

    def batches():
        return pipeline.iter_tile_batches([reader], cfg, BATCH_TILES,
                                          alloc=pipeline.pinned_empty)

    streamed = list(batches())
    require([i for i, _ in streamed] == list(range(4)),
            f"the paper scene must stream as 4 batches of {BATCH_TILES}")
    require(np.array_equal(np.concatenate([b.tiles for _, b in streamed]),
                           bundle.tiles)
            and np.array_equal(np.concatenate([b.headers
                                               for _, b in streamed]),
                               bundle.headers),
            "the streamed tiles and headers differ from tile_scene's")
    log(f"  {len(streamed)} batches of {tuple(streamed[0][1].tiles.shape)} "
        f"({streamed[0][1].tiles.nbytes / 1e6:.1f} MB each): tiles and "
        f"headers bitwise equal to tile_scene's")

    # 2. all seven algorithms through the prefetcher, kernel route
    def extract(b):
        return engine.extract_features_multi(b.tiles, b.headers,
                                             PAPER_ALGORITHMS, cfg,
                                             device=dev)

    def pipelined():
        with pipeline.Prefetcher(batches(), depth=2, device_put=True,
                                 device=dev) as pf:
            return {idx: extract(b) for idx, b in pf}

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = pipelined()
    torch.cuda.synchronize()
    launches_3c = ops.launch_counts()
    for name in MAIN_KERNELS:
        require(launches_3c[name] >= 1,
                f"kernel {name} was not launched on the streamed path")
    require(launches_3c["scalespace"] == 0,
            "the scale-space kernel ran on the streamed tile-512 path")
    for alg in PAPER_ALGORITHMS:
        per_tile = sum((out[i][alg]["per_tile_count"].tolist()
                        for i in sorted(out)), [])
        require(per_tile == scene_counts[alg],
                f"{alg}: streamed per-tile counts differ from phase 3's")
        against_reference(f"{alg} (streamed, pipelined)", per_tile,
                          {mode: reference["tile512"][mode][alg]
                           for mode in ("fma", "no_fma")})
    log(f"  pipelined, kernel route: launches {launches_3c}; per-tile "
        f"counts of all seven algorithms equal phase 3's")
    del out

    def ingest_only():
        for _ in batches():
            pass

    def to_device(b):
        return TileBundle(torch.from_numpy(b.tiles).to(dev),
                          torch.from_numpy(b.headers).to(dev), cfg)

    staged = [to_device(b) for _, b in streamed]

    def extraction_only():
        for b in staged:
            extract(b)

    def serial():
        for _, b in batches():
            extract(to_device(b))

    def staging_only():
        with pipeline.Prefetcher(batches(), depth=2, device_put=True,
                                 device=dev) as pf:
            for _ in pf:
                pass

    def packed_in_advance():
        with pipeline.Prefetcher(iter(streamed), depth=2, device_put=True,
                                 device=dev) as pf:
            for _, b in pf:
                extract(b)

    loops = {"ingest": ingest_only, "extraction": extraction_only,
             "serial": serial, "pipelined": pipelined,
             "staging": staging_only, "packed": packed_in_advance}
    secs = {name: host_s(fn, 3) for name, fn in loops.items()}
    overlap = ((secs["ingest"] + secs["extraction"] - secs["pipelined"])
               / min(secs["ingest"], secs["extraction"]))
    log("streamed_scene_s " + json.dumps(secs) + f" overlap {overlap:.4f}")
    log(f"  seconds a streamed paper scene (host clock ending in a "
        f"synchronize, median of 3): ingest alone {secs['ingest']:.4f}, "
        f"extraction alone (batches staged in advance) "
        f"{secs['extraction']:.4f}, serial {secs['serial']:.4f}, pipelined "
        f"{secs['pipelined']:.4f}; overlap (ingest + extraction - "
        f"pipelined) / min(ingest, extraction) = {overlap:.4f}; the "
        f"prefetcher's thread alone (ingest and copies, no extraction) "
        f"{secs['staging']:.4f}; the prefetcher over batches packed in "
        f"advance (copies under extraction, no tiling) {secs['packed']:.4f}")
    del staged
    # the staged batches' copies: from pinned memory, on a stream that runs
    # none of the engine's kernels; the engine's own copies (small, from
    # pageable memory) stay on its stream.  The profiler may drop some of
    # the staged copies: each of up to 3 sessions must hold the rule, and
    # the one that recorded the most is reported
    best = None
    for _ in range(3):
        acts = device_activity(torch, pipelined)
        require(acts, "the profiler recorded no device activity")
        kernel_streams = {st for name, st in acts
                          if not name.startswith(("Memcpy", "Memset"))}
        h2d = [(name, st) for name, st in acts
               if name.startswith("Memcpy HtoD")]
        copies = [(name, st) for name, st in h2d if st not in kernel_streams]
        require(copies and all("Pinned -> Device" in name
                               for name, _ in copies),
                f"the staged copies are missing or not from pinned memory: "
                f"{collections.Counter(copies)}")
        require(not any("Pinned -> Device" in name for name, st in h2d
                        if st in kernel_streams),
                "a copy from pinned memory ran on the engine's stream")
        if best is None or len(copies) > len(best[0]):
            best = (copies, kernel_streams, collections.Counter(h2d))
        if len(copies) >= 2 * len(streamed):
            break
    copies, kernel_streams, h2d = best
    log(f"  under the profiler: {len(copies)} of the {2 * len(streamed)} "
        f"staged copies recorded, all 'Pinned -> Device', on stream(s) "
        f"{sorted({st for _, st in copies})}; the engine's kernels on "
        f"stream(s) {sorted(kernel_streams)}; host-to-device copies by "
        f"(kind, stream) {dict(h2d)}")

    # 3. the Table-1 sweep: 3 RGBA band scenes of the paper's size, workers
    # 1, 2 and 4 simulated on the card
    t0 = time.perf_counter()
    readers = scale.build_scene_set(ROOT / "build" / "chip_smoke_table1", 3,
                                    cfg.scene_hw)
    log(f"Table-1 sweep: {len(readers)} RGBA band scenes of "
        f"{readers[0].shape}, written or reopened in "
        f"{time.perf_counter() - t0:.1f} s; DifetConfig(), batches of "
        f"{BATCH_TILES}, workers {SWEEP_WORKERS}, "
        f"{','.join(SWEEP_ALGORITHMS)}")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    table1 = scale.run_scaling(readers, cfg, SWEEP_ALGORITHMS, SWEEP_WORKERS,
                               batch_tiles=BATCH_TILES, device=dev)
    sweep_launches = ops.launch_counts()
    scale.print_table(table1, SWEEP_WORKERS)
    for name in MAIN_KERNELS:
        require(sweep_launches[name] >= 1,
                f"kernel {name} was not launched by the sweep")
    for row in table1:
        require(row["n_batches"] == 12, f"{row['n_batches']} batches")
        require(row["parity"], f"{row['algorithm']}: a worker count changed "
                f"the results")
        require(row["total_count"] > 0, f"{row['algorithm']}: no feature")
    log("table1 " + json.dumps(table1))
    log(f"  parity at workers {SWEEP_WORKERS} for every algorithm; launches "
        f"{sweep_launches}; sweep {time.perf_counter() - t0:.1f} s")

    # 4. the extraction driver: killed after one bundle, resumed; a second
    # store on the plain route
    stores = {use: ROOT / "build" / f"chip_smoke_extract_{use}"
              for use in ("kernels", "plain")}
    for path in stores.values():
        shutil.rmtree(path, ignore_errors=True)
    kernel_args = DRIVER_ARGS + ["--store", str(stores["kernels"])]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        extract_cli.main(kernel_args + ["--fail-after", "1"])
    except SystemExit as e:
        require(e.code == 2, f"--fail-after 1 exited {e.code}, not 2")
    else:
        require(False, "--fail-after 1 did not stop the driver")
    t_killed = time.perf_counter() - t0
    t0 = time.perf_counter()
    summary = extract_cli.main(kernel_args)
    t_resume = time.perf_counter() - t0
    driver_launches = ops.launch_counts()
    require(summary["bundles_done"] == summary["bundles_total"] == 3,
            f"the resumed driver finished {summary['bundles_done']} of "
            f"{summary['bundles_total']} bundles")
    require(driver_launches["scalespace"] >= 1,
            "the scale-space kernel did not launch on the driver's path")
    t0 = time.perf_counter()
    plain = extract_cli.main(DRIVER_ARGS + ["--store", str(stores["plain"]),
                                            "--no-use-kernels"])
    t_plain = time.perf_counter() - t0
    bk, bp = (BundleStore(stores[use]) for use in ("kernels", "plain"))
    require(bk.list() == bp.list() and len(bk.list()) == 3,
            "the two stores hold other bundles")
    for name in bk.list():
        a, b = bk.get(name), bp.get(name)
        require(np.array_equal(a.tiles, b.tiles)
                and np.array_equal(a.headers, b.headers),
                f"{name}: the two stores' bundles differ")
        for alg in DRIVER_ALGORITHMS:
            rk, rp = ({k: torch.from_numpy(v) for k, v in
                       st.get_result(f"{name}.{alg}").items()}
                      for st in (bk, bp))
            same_routes(f"{name}/{alg} (driver)", rk, rp, 256)
    log(f"  extraction driver ({' '.join(DRIVER_ARGS)}): --fail-after 1 "
        f"exited 2 ({t_killed:.1f} s, scenes and store included), resumed "
        f"to {summary['bundles_done']}/{summary['bundles_total']} bundles "
        f"({t_resume:.1f} s); launches {driver_launches}; plain-route store "
        f"({t_plain:.1f} s): bundles bitwise equal, results equal per bundle "
        f"and algorithm; totals "
        + json.dumps({alg: summary["per_algorithm"][alg]["grand_total"]
                      for alg in DRIVER_ALGORITHMS}))
    require(all(summary["per_algorithm"][alg]["grand_total"]
                == plain["per_algorithm"][alg]["grand_total"]
                for alg in DRIVER_ALGORITHMS), "the driver's totals differ "
            "across routes")

    phase_done("3c (streamed ingest, Table-1 sweep, extraction driver)")

    # ---- 3d. the feature service: one CUDA graph per (bucket, set) ----------
    log("feature service at ServeConfig() (buckets 32/64/128/256, batch 8, "
        "K 128, halo 16), one CUDA graph per (bucket, algorithm set):")
    served = serve_phase(torch, np, scene)
    phase_done("3d (feature service)")

    # ---- 3e. the replica fleet ---------------------------------------------
    log("replica fleet at ServeConfig() (router, process and thread "
        "replicas on the card, kill -9, the telemetry plane):")
    fleet_figures = fleet_phase(torch, np, served["closed_uncached"])
    phase_done("3e (replica fleet)")

    # ---- 3f. the data mesh on the one card ----------------------------------
    from repro_torch.distributed import Mesh
    log(f"data mesh on one card: the card listed {MESH_REPEAT} times "
        f"and 3 times (uneven splits):")
    mesh_figures = mesh_phase(torch, np, dev,
                              [Mesh([dev] * MESH_REPEAT), Mesh([dev] * 3)],
                              bundle, bundle256, store)
    torch.cuda.empty_cache()
    phase_done("3f (data mesh)")

    # ---- 3g. the LM substrate's serving path ---------------------------------
    lm_figures = lm_phase(torch, np)
    phase_done("3g (LM serving path)")

    # ---- 3h. the LM substrate's training path ------------------------------
    log("phase 3h: the LM training path (deterministic mode), bf16 at full "
        "width:")
    train_figures = train_phase(torch)
    phase_done("3h (LM training path)")

    # ---- 3i. the LM substrate's sharding and analysis ----------------------
    log("phase 3i: the LM sharding and analysis (the dry run on the "
        "production mesh, the card's rates, a one-rank NCCL mesh):")
    analysis_figures = analysis_phase(torch)
    phase_done("3i (LM sharding and analysis)")

    # ---- 4. timings ---------------------------------------------------------
    log("timings (median of %d, CUDA events around one call; [device time "
        "per call under torch.profiler]):" % REPS)
    n, h, w = x.shape
    r_h = (len(gaussian_kernel_1d(1.0)) - 1) // 2
    rows = {}

    def timed(fn, plain, work, shape, launches, library_ms=None):
        row = dict(ms=cuda_ms(fn), plain_ms=cuda_ms(plain),
                   library_ms=library_ms, shape=shape, launches=launches,
                   device_ms=device_us_per_call(torch, fn, 10) / 1e3)
        row["bound_ms"], row["bound_by"] = bound(work)
        log(f"  {shape:44s} kernel {row['ms']:.4f} ms "
            f"[{row['device_ms']:.4f}]  plain {row['plain_ms']:.4f} ms  "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})  library "
            + ("-" if library_ms is None else f"{library_ms:.4f} ms")
            + f"  launches per scene {launches}")
        return row

    def weighted(shape_rows):
        """Launch-weighted kernel time and bound over the shapes one run of
        the path gives the kernel."""
        return (sum(r["launches"] * r["ms"] for r in shape_rows),
                sum(r["launches"] * r["bound_ms"] for r in shape_rows))

    harris_rows = [
        timed(lambda: ops.harris(x, k=cfg.harris_k),
              lambda: ref.harris(x, k=cfg.harris_k),
              harris_work(n, h, w, r_h, False), f"harris [{n},{h},{w}]", 1),
        timed(lambda: ops.harris(x, shi_tomasi=True),
              lambda: ref.harris(x, shi_tomasi=True),
              harris_work(n, h, w, r_h, True), f"shi_tomasi [{n},{h},{w}]", 1)]
    rows["harris"] = dict(harris_rows[0])
    # FAST on the path's input and threshold (its row), at the stitch's
    # threshold and on noise; each bound counts the full test only on the
    # pixels that pass the compass pre-test on that input
    arc = cfg.fast_arc
    fast_rows = []
    for img, t, tag in ((x, cfg.fast_threshold, "tiles (the path's)"),
                        (x, STITCH_FAST_THRESHOLD, "tiles"),
                        (noise, cfg.fast_threshold, "uniform noise")):
        survivors = compass_survivors(torch, img, t, arc)
        nonzero = int((ref.fast_score(img, threshold=t, arc=arc) != 0).sum())
        row = timed(lambda img=img, t=t: ops.fast_score(img, threshold=t,
                                                        arc=arc),
                    lambda img=img, t=t: ref.fast_score(img, threshold=t,
                                                        arc=arc),
                    fast_work(n, h, w, arc, survivors),
                    f"fast [{n},{h},{w}] t={t:g} {tag}",
                    launches["fast"] if not fast_rows else 0)
        row["survivors"] = survivors / img.numel()
        log(f"    {100 * row['survivors']:.4f}% of the pixels pass the "
            f"compass pre-test (torch ops on the card), "
            f"{100 * nonzero / img.numel():.4f}% score nonzero")
        fast_rows.append(row)
    rows["fast"] = fast_rows[0]
    # what the early-out buys: the same kernel told m = 0, so that every
    # pixel runs the full test (its C entry accepts any m <= arc // 4)
    from repro_torch.kernels import fastscore as FS

    def full_test_only(img, t):
        out = torch.empty_like(img)
        FS.KERNEL.launch(dev, img.data_ptr(), out.data_ptr(), *img.shape,
                         f32(t), arc, 0)
        return out

    for img, tag in ((x, "tiles"), (noise, "uniform noise")):
        t = cfg.fast_threshold
        require(torch.equal(full_test_only(img, t),
                            ref.fast_score(img, threshold=t, arc=arc)),
                f"fast with m = 0 on {tag} is not bitwise equal to its twin")
        ms = cuda_ms(lambda img=img: full_test_only(img, t))
        dms = device_us_per_call(torch, lambda img=img: full_test_only(img, t),
                                 10) / 1e3
        log(f"  fast [{n},{h},{w}] t={t:g} {tag}, no early-out (m = 0, "
            f"bitwise equal to the twin): kernel {ms:.4f} ms [{dms:.4f}]")
    pre_ops, full_ops = fast_ops(arc)
    log(f"  fast issue floors [{n},{h},{w}] at {FP32_ISSUES_PER_S:.4g} "
        f"instructions/s: the full test on every output "
        f"{n * h * w * (2 + full_ops) / FP32_ISSUES_PER_S * 1e3:.4f} ms "
        f"({2 + full_ops} an output at arc {arc}), the compass pre-test "
        f"alone {n * h * w * pre_ops / FP32_ISSUES_PER_S * 1e3:.4f} ms "
        f"({pre_ops} an output); bytes "
        f"{n * h * w * 8 / HBM_BYTES_PER_S * 1e3:.4f} ms")
    del noise
    # every blur the tile-512 path launches: SIFT's base, octave 0's five
    # increments, BRIEF's and ORB's descriptor blur (one each), SURF's
    # patches; the F.conv2d yardstick at sigma 1.6 (11 x 11, fp32)
    taps = gaussian_kernel_1d(1.6)
    r_b = (len(taps) - 1) // 2
    xp = reflect_pad(x, r_b)[:, None]
    w2d = torch.from_numpy(np.outer(taps, taps)).to(dev)[None, None]
    conv_ms = cuda_ms(lambda: F.conv2d(xp, w2d))
    del xp
    blur_shapes = [(x, 1.6, "tiles s=1.600 (SIFT base)", 1)]
    blur_shapes += [(base0, s, f"octave0 inc{i} s={s:.3f}", 1)
                    for i, s in enumerate(incs, 1)]
    blur_shapes += [(x, 2.0, "tiles s=2.000 (BRIEF, ORB)", 2),
                    (patches, 1.0, "patches s=1.000 (SURF)", 1)]
    require(sum(b[3] for b in blur_shapes) == launches["blur"],
            f"the timed blur shapes are not the {launches['blur']} blur "
            f"launches of the main path")
    blur_rows = []
    for img, sigma, tag, count in blur_shapes:
        r = (len(gaussian_kernel_1d(sigma)) - 1) // 2
        bn, bh, bw = img.shape
        blur_rows.append(timed(
            lambda img=img, sigma=sigma: ops.gaussian_blur(img, sigma),
            lambda img=img, sigma=sigma: ref.gaussian_blur(img, sigma),
            blur_work(bn, bh, bw, r), f"blur [{bn},{bh},{bw}] {tag}", count,
            conv_ms if sigma == 1.6 else None))
    rows["blur"] = dict(blur_rows[0])
    # the scale-space kernel on its own path (tile 256: 961 octaves of 304^2;
    # the twin on the first 128 of them)
    rows["scalespace"] = timed(
        lambda: ops.scalespace_octave(base304, scales_per_octave=3,
                                      contrast_threshold=thr),
        lambda: ref.scalespace_octave(base304, scales_per_octave=3,
                                      contrast_threshold=thr),
        scalespace_work(*base304.shape, ss_radii),
        f"scalespace [{base304.shape[0]},304,304] octave 0, tile 256",
        launches256["scalespace"])
    base304_all = ops.gaussian_blur(tiles256, 1.6)

    def ss_launch():
        return ops.scalespace_octave(base304_all, scales_per_octave=3,
                                     contrast_threshold=thr)

    ss_full = dict(ms=cuda_ms(ss_launch), launches=launches256["scalespace"],
                   device_ms=device_us_per_call(torch, ss_launch, 3) / 1e3)
    ss_full["bound_ms"], _ = bound(scalespace_work(*base304_all.shape,
                                                   ss_radii))
    ss_n, ss_h, ss_w = base304_all.shape
    ss_wt, ss_smem, ss_per_sm = SS.geometry(3, 1.6, ss_w)
    ss_strips = -(-ss_w // ss_wt)
    ss_floor = scalespace_issue_ops(ss_n, ss_h, ss_w, ss_radii, ss_wt) \
        / FP32_ISSUES_PER_S * 1e3
    log(f"  scalespace [{ss_n},{ss_h},{ss_w}] (the tile-256 path's launch) "
        f"kernel {ss_full['ms']:.4f} ms [{ss_full['device_ms']:.4f}]  bound "
        f"{ss_full['bound_ms']:.4f} ms; exact-order issue floor at its own "
        f"geometry {ss_floor:.4f} ms (tap passes of 4r + 1 fp32 "
        f"instructions an output over each level's strip width and rows, "
        f"and the DoG, at {FP32_ISSUES_PER_S:.4g}/s)")
    log(f"  scalespace geometry: strip width {ss_wt}, {ss_strips} strips an "
        f"image, grid {ss_n * ss_strips} blocks, {ss_smem} B of shared "
        f"memory a block, {ss_per_sm} blocks per SM")
    require(ss_per_sm >= 2, "the scale-space kernel must fit two blocks "
            "on an SM at the default octave")
    del base304_all
    path_totals = {"harris": weighted(harris_rows),
                   "fast": weighted([rows["fast"]]),
                   "blur": weighted(blur_rows),
                   "scalespace": weighted([ss_full]),
                   "select": select_total}
    rows["select"] = dict(select_rows["paper"][0], library_ms=None)
    for name, (t_ms, b_ms) in path_totals.items():
        log(f"  {name:10s} launch-weighted over its path: kernel "
            f"{t_ms:.4f} ms, bound {b_ms:.4f} ms")

    # the matcher at the scene pair's shapes and on the 1M-row stream; the
    # event floor (an empty call between the two events) sets how far a call
    # of a few microseconds on the card can be timed by events at all
    from repro_torch.kernels import matcher as M
    mrng = np.random.RandomState(2)
    mtimes = {}
    alloc = lambda: torch.empty((3, 2048), dtype=torch.int32, device=dev)
    log(f"  event floor: an empty call timed by events "
        f"{cuda_ms(lambda: None) * 1e3:.1f} us; an allocation of [3, 2048] "
        f"int32 {cuda_ms(alloc) * 1e3:.1f} us by events, "
        f"{host_us_per_call(torch, alloc):.1f} us on the host")
    for metric, width, nq, nk, frac in (("hamming", 8, 2048, 2048, 0.2),
                                        ("l2", 128, 2048, 2048, 0.2),
                                        ("l2", 64, 2048, 2048, 0.8),
                                        ("hamming", 8, 2048, 1 << 20, 0.2)):
        if metric == "hamming":
            mk = lambda n: torch.from_numpy(mrng.randint(
                0, 2 ** 32, (n, width), dtype=np.uint64).astype(np.uint32)
                .view(np.int32)).to(dev)
        else:
            mk = lambda n: torch.from_numpy(
                mrng.randn(n, width).astype(np.float32)).to(dev)
        q, db = mk(nq), mk(nk)
        v = torch.from_numpy((mrng.rand(nk) >= frac).astype(np.int32)).to(dev)
        big = nk > 1 << 17
        work = match_work(nq, int(v.sum()), nk, width, metric)
        b_ms, b_by = match_bound(work, metric)
        full_ms = None if big else cuda_ms(
            lambda: M.best2_full(q, db, v, metric=metric))
        reps = dict(reps=3, warmup=1) if big else {}
        row = dict(ms=cuda_ms(lambda: M.match(q, db, v, metric=metric)),
                   plain_ms=cuda_ms(lambda: M.best2_scan(q, db, v,
                                                         metric=metric),
                                    **reps),
                   bound_ms=b_ms, bound_by=b_by, torch_full_ms=full_ms)
        extra = ""
        if not big:
            row["resident_ms"] = cuda_ms(lambda: M.launch(
                q, db, v, metric=metric, segments=1))
            row["device_us"] = device_us_per_call(
                torch, lambda: M.match(q, db, v, metric=metric), 20)
            row["host_us"] = host_us_per_call(
                torch, lambda: M.match(q, db, v, metric=metric))
            row["host_us_ops"] = host_us_per_call(
                torch, lambda: ops.match_best2(q, db, v, metric=metric,
                                               path="cuda_stream"))
            extra = (f"; one segment (cuda_resident) {row['resident_ms']:.4f} "
                     f"ms; device time per call under the profiler "
                     f"{row['device_us']:.1f} us; host per call "
                     f"{row['host_us']:.1f} us (match), "
                     f"{row['host_us_ops']:.1f} us (ops.match_best2)")
        mtimes[(metric, nk, width)] = row
        n_seg = M.plan(nq, nk, M.slots(torch.cuda.current_device(), metric,
                                       width))
        log(f"  matcher {metric:7s} {nq}x{nk}x{width} ({int(v.sum())} valid "
            f"rows; {n_seg} segments): kernel "
            f"{row['ms']:.4f} ms  twin {row['plain_ms']:.4f} ms  "
            f"torch_full "
            + ("-" if full_ms is None else f"{full_ms:.4f} ms")
            + f"  bound {b_ms:.4f} ms ({b_by}; popc at "
            f"{POPC_PER_S:.3g}/s, fp32 at {FP32_OPS_PER_S:.3g}/s, "
            f"{HBM_BYTES_PER_S:.3g} B/s)  launches on the matching path "
            f"{match_launches['matcher']}" + extra)
        del q, db, v
    rows["matcher"] = dict({k: v for k, v in mtimes[("hamming", 2048,
                                                     8)].items()
                            if k != "resident_ms"}, library_ms=None)
    # the matching path's own launches, each timed on the inputs it was given
    # (L2 for sift and surf, Hamming for brief and orb and the stitch) with
    # its own bound from its valid rows, by events and under the profiler
    match_rows = {}
    for q, db, v, metric, path in match_calls:
        key = (metric, q.shape[0], db.shape[0], q.shape[1], int(v.sum()),
               path)
        if key not in match_rows:
            b_ms, _ = match_bound(match_work(key[1], key[4], key[2], key[3],
                                             metric), metric)
            fn = ops._PATH_FNS[path]
            match_rows[key] = dict(
                ms=cuda_ms(lambda: fn(q, db, v, metric=metric)),
                device_ms=device_us_per_call(
                    torch, lambda: fn(q, db, v, metric=metric), 20) / 1e3,
                bound_ms=b_ms, launches=0)
        match_rows[key]["launches"] += 1
    for (metric, nq, nk, width, nv, path), row in match_rows.items():
        log(f"  matcher on the matching path: {metric:7s} {nq}x{nk}x{width} "
            f"({nv} valid rows; {path}) kernel {row['ms']:.4f} ms "
            f"[{row['device_ms']:.4f}]  bound {row['bound_ms']:.4f} ms  "
            f"launches {row['launches']}")
    require(sum(r["launches"] for r in match_rows.values())
            == match_launches["matcher"],
            "the timed matcher launches are not the matching path's")
    path_totals["matcher"] = weighted(list(match_rows.values()))
    device_total = sum(r["launches"] * r["device_ms"]
                       for r in match_rows.values())
    log(f"  {'matcher':10s} launch-weighted over its path: kernel "
        f"{path_totals['matcher'][0]:.4f} ms [{device_total:.4f}], bound "
        f"{path_totals['matcher'][1]:.4f} ms")
    del match_calls

    # where the time goes: the scene, stage by stage, kernel route
    stage = {}
    resp = {}
    for fn in (engine._harris_resp, engine._shi_resp, engine._sift_resp,
               engine._surf_resp, engine._fast_resp):
        stage[f"response {fn.__name__[1:-5]}"] = cuda_ms(
            lambda fn=fn: fn(x, cfg, True), reps=3, warmup=1)
        resp[fn] = fn(x, cfg, True)
    for alg in PAPER_ALGORITHMS:
        stage[f"select+describe {alg}"] = cuda_ms(
            lambda alg=alg: engine._select_and_describe(
                alg, cfg, x, headers, resp[engine.ALGORITHMS[alg].response],
                True), reps=3, warmup=1)
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

    phase_done("4 (timings)")

    # ---- 5. results ---------------------------------------------------------
    # launches: from the run of the path each kernel is on (scalespace: the
    # tile-256 SIFT run; the matcher: the matching path; the others: the
    # tile-512 main path)
    path_launches = {name: launches[name] for name in MAIN_KERNELS}
    path_launches["scalespace"] = launches256["scalespace"]
    path_launches["matcher"] = match_launches["matcher"]
    kernels = []
    for name in EXTRACT_KERNELS + MATCH_KERNELS:
        row = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"{CSRC}/{SOURCES[name]}", "replaces": REPLACES[name],
            "launches": path_launches[name], "max_abs_err": err[name],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "launch_weighted_ms": path_totals[name][0],
            "launch_weighted_bound_ms": path_totals[name][1]})
        if name in served["per_replay"]:
            kernels[-1]["served_launches_per_replay"] = \
                served["per_replay"][name]
    log("serve " + json.dumps({k: v for k, v in served.items()
                               if k != "per_replay"}))
    log("fleet " + json.dumps(fleet_figures))
    log("mesh " + json.dumps(mesh_figures))
    log("lm " + json.dumps(lm_figures))
    log("train " + json.dumps(train_figures))
    log("analysis " + json.dumps(analysis_figures))
    from repro_torch.kernels import dispatch
    log("dispatch " + json.dumps(dispatch.explain()))
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
    if sys.argv[1:2] == ["--mesh-cards"] and len(sys.argv) == 3:
        sys.exit(mesh_cards_main(int(sys.argv[2])))
    if sys.argv[1:2] == ["--lm-worker"] and len(sys.argv) == 5:
        sys.exit(lm_worker_main(sys.argv[2], tuple(
            int(n) for n in sys.argv[3].split("x")), Path(sys.argv[4])))
    if sys.argv[1:] == ["--select"]:
        sys.exit(main(select_only=True))
    if sys.argv[1:]:
        print("usage: chip_smoke.py [--mesh-cards N | --select]",
              file=sys.stderr)
        sys.exit(2)
    sys.exit(main())
