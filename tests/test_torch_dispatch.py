"""The port's measured matcher dispatch (``repro_torch.kernels.dispatch``,
``ops.match_path``, ``launch/obs.py --explain-dispatch``) against the JAX
package's (``repro.kernels.dispatch``), on the CPU.

The reference's dispatch tests (``tests/test_dispatch.py`` and the two of
``tests/test_obs.py``) are ported one for one; the rest hold the port to the
reference: bucketing, keys, candidate sets (``cpu`` <-> ``cpu``, ``cuda``
<-> ``tpu``), probe bits, the cache file's decoding and its rendering, and
the default route's results (Hamming exact; L2 within rtol 1e-5 / atol 1e-4,
the tolerance of ``tests/test_matcher.py``).  Every test points both
packages' cache files at ``tmp_path``.  ~10 s in one process.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.launch import obs as jobs_cli
from repro_torch.kernels import dispatch, matcher, ops
from repro_torch.launch import obs as obs_cli
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import profile as obs_profile

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

# the reference's path names -> the port's
TO_PORT = {"jnp_full": "torch_full", "jnp_stream": "torch_stream",
           "pallas_resident": "cuda_resident", "pallas_stream": "cuda_stream"}
TO_PORT_BACKEND = {"cpu": "cpu", "tpu": "cuda"}


@pytest.fixture
def fresh_cache(tmp_path, monkeypatch):
    """Both packages' dispatch caches at empty per-test files, both memos
    dropped, so tests never see (or pollute) the user's caches."""
    path = str(tmp_path / "dispatch.json")
    monkeypatch.setenv(dispatch.CACHE_ENV, path)
    monkeypatch.setenv(jdispatch.CACHE_ENV, str(tmp_path / "ref.json"))
    dispatch.clear_memory_cache()
    jdispatch.clear_memory_cache()
    yield path
    dispatch.clear_memory_cache()
    jdispatch.clear_memory_cache()


def packed(n, seed, words=8):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 2 ** 32, size=(n, words),
                       dtype=np.uint64).astype(np.uint32)


# --- the reference's dispatch tests, ported ------------------------------------
def test_shape_bucket_rounds_up_pow2_keeps_d_exact():
    assert dispatch.shape_bucket(100, 3000, 128) == (128, 4096, 128)
    assert dispatch.shape_bucket(128, 4096, 8) == (128, 4096, 8)
    assert dispatch.shape_bucket(1, 1, 64) == (1, 1, 64)
    # same bucket -> same key; different d -> different key
    k1 = dispatch.bucket_key("l2", "cpu", 100, 3000, 128)
    assert k1 == dispatch.bucket_key("l2", "cpu", 128, 4096, 128)
    assert k1 != dispatch.bucket_key("l2", "cpu", 128, 4096, 64)
    assert ops.shape_bucket is dispatch.shape_bucket


def test_candidate_paths_eligibility():
    # CPU: no kernel candidate (the wrappers run their twins there)
    assert dispatch.candidate_paths("l2", "cpu", 4096, 128) == \
        dispatch.TORCH_PATHS
    # big DB drops the materializing candidates everywhere
    big = dispatch.FULL_MAX_ROWS + 1
    assert dispatch.candidate_paths("l2", "cpu", big, 128) == \
        ("torch_stream",)
    assert dispatch.candidate_paths("hamming", "cuda", big, 8) == \
        ("cuda_stream",)
    # the card, small DB: the kernel's two plans compete, and a torch path
    # runs there only when asked for
    assert dispatch.candidate_paths("hamming", "cuda", 4096, 8) == \
        dispatch.CUDA_PATHS
    assert dispatch.candidate_paths("hamming", "cuda", 4096, 8,
                                    use_kernels=False) == dispatch.TORCH_PATHS
    # use_kernels restricts the pool
    assert dispatch.candidate_paths("l2", "cpu", 4096, 128,
                                    use_kernels=False) == dispatch.TORCH_PATHS
    assert dispatch.candidate_paths("hamming", "cuda", 4096, 8,
                                    use_kernels=True) == dispatch.CUDA_PATHS
    assert dispatch.candidate_paths("hamming", "cpu", 4096, 8,
                                    use_kernels=True) == ("cuda_stream",)


def test_choose_path_measures_once_then_memoizes(fresh_cache):
    before = dispatch.measure_count
    p1 = dispatch.choose_path("l2", 64, 2048, 64, backend="cpu")
    measured = dispatch.measure_count - before
    assert measured == len(dispatch.candidate_paths(
        "l2", "cpu", 2048, 64))              # one probe per candidate
    assert p1 in dispatch.TORCH_PATHS
    # same bucket again (even a different shape inside it): no re-measure
    p2 = dispatch.choose_path("l2", 33, 1100, 64, backend="cpu")
    assert p2 == p1
    assert dispatch.measure_count == before + measured


def test_choose_path_single_candidate_skips_measurement(fresh_cache):
    before = dispatch.measure_count
    p = dispatch.choose_path("l2", 64, dispatch.FULL_MAX_ROWS + 1, 64,
                             backend="cpu")
    assert p == "torch_stream"
    assert dispatch.choose_path("l2", 64, 100, 64, backend="cpu",
                                use_kernels=True) == "cuda_stream"
    assert dispatch.measure_count == before   # nothing to race: no probe
    assert not os.path.exists(fresh_cache)


def test_disk_cache_survives_memory_clear(fresh_cache):
    before = dispatch.measure_count
    p1 = dispatch.choose_path("hamming", 64, 1024, 8, backend="cpu")
    measured = dispatch.measure_count - before
    assert measured > 0
    assert os.path.exists(fresh_cache)
    entry = json.load(open(fresh_cache))
    [(key, val)] = entry.items()
    assert val["path"] == p1 and "us" in val
    # a "new process": empty memo, same disk file -> disk hit, no probe
    dispatch.clear_memory_cache()
    p2 = dispatch.choose_path("hamming", 64, 1024, 8, backend="cpu")
    assert p2 == p1
    assert dispatch.measure_count == before + measured


def test_corrupt_disk_cache_remeasures(fresh_cache):
    with open(fresh_cache, "w") as f:
        f.write("{not json")
    before = dispatch.measure_count
    p = dispatch.choose_path("l2", 32, 512, 32, backend="cpu")
    assert p in dispatch.TORCH_PATHS
    assert dispatch.measure_count > before    # fell through to measurement


def test_match_best2_uses_dispatch_and_probe_caps(fresh_cache):
    """End to end: a default (use_kernels=None) call triggers exactly one
    measurement round; probes never materialize beyond the caps."""
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(40, 32).astype(np.float32))
    db = torch.from_numpy(rng.randn(900, 32).astype(np.float32))
    before = dispatch.measure_count
    out1 = ops.match_best2(q, db, metric="l2")
    assert dispatch.measure_count > before
    after = dispatch.measure_count
    out2 = ops.match_best2(q, db, metric="l2")
    assert dispatch.measure_count == after
    for a, b in zip(out1, out2):
        assert torch.equal(a, b)
    us = dispatch.measure_path("torch_stream", "l2",
                               dispatch.PROBE_NQ_CAP * 4,
                               dispatch.PROBE_NK_CAP * 4, 16)
    assert us > 0.0


def test_match_best2_profiles_by_dispatch_bucket(fresh_cache):
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(16, 32).astype(np.float32))
    db = torch.from_numpy(rng.randn(200, 32).astype(np.float32))
    base = ops.match_best2(q, db, metric="l2")
    prev = obs_profile.set_profiler(obs_profile.KernelProfiler())
    try:
        out = ops.match_best2(q, db, metric="l2")
        rows = obs_profile.profiler().snapshot()
        match_rows = [k for k in rows if k.startswith("match:l2:")]
        assert match_rows, rows
        assert "q16k256d32" in match_rows[0]     # pow2 dispatch bucket key
    finally:
        obs_profile.set_profiler(prev)
    for a, b in zip(base, out):                  # profiling never forks bits
        assert torch.equal(a, b)


def test_dispatch_cache_provenance_and_explain(fresh_cache):
    """Every measured verdict persists WHY it won — candidate set,
    per-candidate timings, probe shape — and explain() decodes it; the
    measures are counted in the registry."""
    counter = obs_metrics.registry().counter("difet.kernel.dispatch_measures")
    n0 = counter.value
    p = dispatch.choose_path("l2", 32, 512, 16, backend="cpu")
    assert counter.value == n0 + 2
    entry = json.load(open(fresh_cache))
    [(key, val)] = entry.items()
    assert key == "l2|cpu|q32|k512|d16|tfts"
    assert set(val) == {"path", "us", "probe", "metric", "backend",
                        "bucket", "candidates"}
    assert val["path"] == p
    assert val["metric"] == "l2" and val["backend"] == "cpu"
    assert val["bucket"] == [32, 512, 16] and val["probe"] == [32, 512, 16]
    assert sorted(val["candidates"]) == sorted(val["us"])
    assert all(us > 0 for us in val["us"].values())
    rows = dispatch.explain()
    assert rows[key]["path"] == p
    assert rows[key]["margin"] >= 1.0        # winner beat the runner-up


# --- the port against the reference ---------------------------------------------
def test_shape_bucket_and_key_prefix_match_reference():
    for nq in (0, 1, 2, 3, 100, 128, 129, 2048, 5000):
        for nk in (0, 1, 7, 1024, 1025, 1 << 17, (1 << 17) + 1):
            for d in (1, 8, 64, 128):
                assert dispatch.shape_bucket(nq, nk, d) == \
                    jdispatch.shape_bucket(nq, nk, d)
                for metric in ("l2", "hamming"):
                    for pb, jb in TO_PORT_BACKEND.items():
                        want = jdispatch.bucket_key(metric, jb, nq, nk, d)
                        got = dispatch.bucket_key(metric, pb, nq, nk, d)
                        assert got.replace(f"|{pb}|", f"|{jb}|") == want
    assert (dispatch.FULL_MAX_ROWS, dispatch.PROBE_NQ_CAP,
            dispatch.PROBE_NK_CAP, dispatch._PROBE_REPS) == \
        (jdispatch.FULL_MAX_ROWS, jdispatch.PROBE_NQ_CAP,
         jdispatch.PROBE_NK_CAP, jdispatch._PROBE_REPS)
    assert dispatch.MATCH_PATHS == tuple(TO_PORT[p]
                                         for p in jdispatch.MATCH_PATHS)
    assert ops.MATCH_PATHS == dispatch.MATCH_PATHS


@pytest.mark.parametrize("metric,d", [("l2", 128), ("l2", 16),
                                      ("hamming", 8)])
def test_candidate_paths_map_to_reference(metric, d):
    """One to one, apart from three stated cases: the reference's TPU VMEM
    rule (a database over its 12 MiB budget drops ``pallas_resident``; the
    port keeps ``cuda_resident`` up to FULL_MAX_ROWS); the card's measured
    default (``use_kernels=None`` on ``cuda`` holds only the kernel's
    plans, where the reference's ``tpu`` set adds its jnp paths: the card
    never gives way to a torch path unasked); and ``use_kernels=True`` on
    the CPU, where the port's set is its one kernel path (``cuda_stream``,
    the twin on CPU tensors) while the reference's ``candidate_paths``
    gives its jnp paths (its ``match_path`` never asks it there: it takes a
    Pallas kernel in interpret mode)."""
    vmem_cases = card_default_cases = 0
    for nk in (1, 4096, dispatch.FULL_MAX_ROWS, dispatch.FULL_MAX_ROWS + 1):
        for use in (None, False, True):
            for jb, pb in TO_PORT_BACKEND.items():
                want = tuple(TO_PORT[c] for c in jdispatch.candidate_paths(
                    metric, jb, nk, d, use))
                got = dispatch.candidate_paths(metric, pb, nk, d, use)
                if pb == "cpu" and use is True:
                    assert got == ("cuda_stream",)
                    assert jops.match_path(64, nk, d, metric=metric,
                                           use_pallas=True, backend=jb) \
                        in ("pallas_resident", "pallas_stream")
                    continue
                if pb == "cuda" and use is None:
                    card_default_cases += 1
                    assert "jnp_stream" in jdispatch.candidate_paths(
                        metric, jb, nk, d, use)
                    want = tuple(c for c in want if c in dispatch.CUDA_PATHS)
                if (pb == "cuda" and use is not False
                        and nk <= dispatch.FULL_MAX_ROWS
                        and not jops.matcher_fits_vmem(nk, d, metric)):
                    vmem_cases += 1
                    assert "pallas_resident" not in \
                        jdispatch.candidate_paths(metric, jb, nk, d, use)
                    assert got == tuple(c for c in dispatch.MATCH_PATHS
                                        if c in want or c == "cuda_resident")
                    continue
                assert got == want, (nk, use, jb)
    assert card_default_cases == 4
    if (metric, d) == ("l2", 128):     # FULL_MAX_ROWS x 128 fp32: 64 MiB
        assert vmem_cases == 2             # use_kernels None and True


@pytest.mark.parametrize("metric,d", [("hamming", 8), ("l2", 64)])
def test_probe_arrays_equal_reference_bits(metric, d):
    got = dispatch._probe_arrays(metric, 37, 300, d)
    want = jdispatch._probe_arrays(metric, 37, 300, d)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.view(w.dtype) if g.dtype != w.dtype
                                      else g, w)
    assert got[0].dtype == (np.int32 if metric == "hamming" else np.float32)


def test_explain_decodes_reference_cache_row_for_row(fresh_cache, tmp_path,
                                                     monkeypatch):
    """A cache file the reference's ``choose_path`` wrote, plus one entry
    written before the provenance fields, decodes row for row as the
    reference decodes it."""
    ref_file = str(tmp_path / "ref.json")
    jdispatch.choose_path("l2", 32, 512, 16, backend="cpu")
    jdispatch.choose_path("hamming", 64, 1024, 8, backend="cpu")
    doc = json.load(open(ref_file))
    assert len(doc) == 2
    doc["l2|tpu|q8|k64|d4|jfjs"] = {"path": "jnp_stream",
                                    "us": {"jnp_full": 3.0, "jnp_stream": 2.0}}
    doc["hamming|tpu|q8|k64|d4|ps"] = {"path": "pallas_stream"}
    doc["garbage"] = [1, 2]
    with open(ref_file, "w") as f:
        json.dump(doc, f)
    monkeypatch.setenv(dispatch.CACHE_ENV, ref_file)
    got, want = dispatch.explain(), jdispatch.explain()
    assert list(got) == list(want) and len(got) == 4
    for key in want:
        assert got[key] == want[key], key
    assert got["l2|tpu|q8|k64|d4|jfjs"]["margin"] == 1.5
    assert "margin" not in got["hamming|tpu|q8|k64|d4|ps"]


def test_explain_dispatch_cli_prints_reference_lines(fresh_cache, tmp_path,
                                                     monkeypatch, capsys):
    """``--explain-dispatch`` prints the reference's lines for the same file;
    on an empty cache only the hint names the port's workload."""
    empty = str(tmp_path / "none.json")
    monkeypatch.setenv(dispatch.CACHE_ENV, empty)
    monkeypatch.setenv(jdispatch.CACHE_ENV, empty)
    assert jobs_cli.explain_dispatch() == 0
    want = capsys.readouterr().out.splitlines()
    with pytest.raises(SystemExit) as e:
        obs_cli.main(["--explain-dispatch"])
    assert e.value.code == 0
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0] and len(got) == len(want) == 2
    assert "chip_smoke.py" in got[1] and "empty" in got[1]

    monkeypatch.setenv(jdispatch.CACHE_ENV, fresh_cache)
    monkeypatch.setenv(dispatch.CACHE_ENV, fresh_cache)
    jdispatch.choose_path("l2", 32, 512, 16, backend="cpu")
    dispatch.choose_path("hamming", 64, 1024, 8, backend="cpu")
    capsys.readouterr()
    assert jobs_cli.explain_dispatch() == 0
    want = capsys.readouterr().out
    assert obs_cli.explain_dispatch() == 0
    got = capsys.readouterr().out
    assert got == want
    assert "l2|cpu|q32|k512|d16|jfjs" in got
    assert "hamming|cpu|q64|k1024|d8|tfts" in got
    assert "winner: " in got and " us" in got


@pytest.mark.parametrize("metric", ["hamming", "l2"])
def test_default_match_best2_equals_reference_and_measures_once(fresh_cache,
                                                                metric):
    rng = np.random.RandomState(3)
    if metric == "hamming":
        q, db = packed(90, 0), packed(700, 1)
        tq = torch.from_numpy(q.view(np.int32))
        tdb = torch.from_numpy(db.view(np.int32))
    else:
        q = rng.randn(90, 64).astype(np.float32)
        db = rng.randn(700, 64).astype(np.float32)
        tq, tdb = torch.from_numpy(q), torch.from_numpy(db)
    v = rng.rand(700) < 0.8
    want = [np.asarray(w) for w in jops.match_best2(
        jnp.asarray(q), jnp.asarray(db), jnp.asarray(v), metric=metric)]
    before = dispatch.measure_count
    got = [g.numpy() for g in ops.match_best2(tq, tdb, torch.from_numpy(v),
                                               metric=metric)]
    assert dispatch.measure_count == before + 2
    if metric == "hamming":
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.view(np.int32))
    else:
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(got[2], want[2])
    again = ops.match_best2(tq, tdb, torch.from_numpy(v), metric=metric)
    assert dispatch.measure_count == before + 2
    for a, b in zip(again, got):
        np.testing.assert_array_equal(a.numpy(), b)
    [entry] = json.load(open(fresh_cache)).values()
    assert entry["bucket"] == [128, 1024, q.shape[1]]
    assert entry["candidates"] == ["torch_full", "torch_stream"]


def test_failing_probe_raises_and_stores_nothing(fresh_cache, monkeypatch):
    def broken(*args, **kw):
        raise RuntimeError("probe failed to launch")

    monkeypatch.setitem(ops._PATH_FNS, "torch_stream", broken)
    with pytest.raises(RuntimeError, match="probe failed to launch"):
        dispatch.choose_path("l2", 16, 300, 8, backend="cpu")
    assert not os.path.exists(fresh_cache)
    assert dispatch.explain() == {}
    with pytest.raises(RuntimeError, match="probe failed to launch"):
        ops.match_best2(torch.zeros(16, 8), torch.zeros(300, 8), metric="l2")


def test_no_measurement_inside_a_graph_capture(fresh_cache, monkeypatch):
    """A bucket with no verdict raises under a CUDA graph capture; one with
    a verdict (here seeded on disk) is answered without measuring."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    before = dispatch.measure_count
    with pytest.raises(RuntimeError, match="CUDA graph capture"):
        dispatch.choose_path("hamming", 128, 2048, 8, backend="cuda")
    key = dispatch.bucket_key("hamming", "cuda", 128, 2048, 8) + "|crcs"
    with open(fresh_cache, "w") as f:
        json.dump({key: {"path": "cuda_resident"}}, f)
    assert dispatch.choose_path("hamming", 100, 2000, 8,
                                backend="cuda") == "cuda_resident"
    assert dispatch.measure_count == before


@pytest.mark.parametrize("resident_us,want,margin", [
    (70.0, "cuda_stream", 70.0 / 100.0),     # 1.43x faster: within the margin
    (40.0, "cuda_resident", 100.0 / 40.0),   # 2.5x faster: it takes the bucket
])
def test_planned_launch_keeps_its_bucket_within_the_margin(
        fresh_cache, monkeypatch, resident_us, want, margin):
    """On the card ``cuda_stream`` (``matcher.plan``'s launch) keeps a bucket
    unless one segment is ``SWITCH_MARGIN`` times faster; ``explain()``'s
    margin is then the other's time over the winner's, below 1 where the
    planned launch stayed.  A contest without it takes the fastest."""
    times = {"cuda_stream": 100.0, "cuda_resident": resident_us,
             "torch_full": 90.0, "torch_stream": 100.0}
    monkeypatch.setattr(dispatch, "measure_path",
                        lambda c, *args: times[c])
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    cpu = torch.device("cpu")
    assert dispatch.choose_path("l2", 512, 2048, 64, backend="cuda",
                                device=cpu) == want
    [row] = dispatch.explain().values()
    assert row["path"] == want and row["margin"] == pytest.approx(margin)
    assert dispatch.choose_path("l2", 512, 2048, 64, backend="cuda",
                                use_kernels=False,
                                device=cpu) == "torch_full"


def test_kernel_plans_on_cpu_tensors_run_the_twin():
    """``cuda_resident`` is the one-segment launch and ``cuda_stream`` the
    planned one; on CPU tensors both run ``best2_scan``."""
    q = torch.from_numpy(packed(33, 4).view(np.int32))
    db = torch.from_numpy(packed(500, 5).view(np.int32))
    v = torch.ones(500, dtype=torch.int32)
    want = matcher.best2_scan(q, db, v, metric="hamming")
    for path in dispatch.CUDA_PATHS:
        got = ops.match_best2(q, db, v, metric="hamming", path=path)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), path
    with pytest.raises(ValueError, match="segments"):
        matcher.launch(q, db, v, metric="hamming", segments=0)
