"""The engine's spans (`core/engine.py`, `obs/trace.py::span`) on the CPU:
all seven algorithms on a 128x128 scene in 16 tiles (tile 32, halo 24,
K 32), and the same scene on a CPU mesh of two entries.

Under ``torch.profiler`` each stage is one ``record_function`` range with
the span's name, nested as the map and reduce nest; with the flight
recorder on, the spans link to their parents and share one trace id a
call; with both off, ``span`` enters no range and reads no clock, and the
results are bitwise those of a traced run.  ~10 s in one process.
"""
import collections
import os
import threading
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.difet_paper import DifetConfig, PAPER_ALGORITHMS
from repro_torch.core import bundle, engine
from repro_torch.data.landsat import synthetic_scene
from repro_torch.distributed import Mesh
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.trace import FlightRecorder, NoopRecorder

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CFG = DifetConfig(tile=32, halo=24, max_keypoints_per_tile=32)
RESPONSES = ("harris", "shi_tomasi", "sift", "surf", "fast")
DESCRIBED = ("sift", "surf", "brief", "orb")
# span name -> how many one call of extract_features_multi opens
EXPECTED = collections.Counter(
    {"difet.extract": 1, "difet.map": 1,
     **{f"difet.response.{r}": 1 for r in RESPONSES},
     **{f"difet.select.{a}": 1 for a in PAPER_ALGORITHMS},
     **{f"difet.describe.{a}": 1 for a in DESCRIBED},
     **{f"difet.reduce.{a}": 1 for a in PAPER_ALGORITHMS}})


@pytest.fixture(scope="module")
def scene():
    b = bundle.tile_scene(synthetic_scene(128, 128, seed=3), CFG)
    return torch.from_numpy(b.tiles), torch.from_numpy(b.headers)


@pytest.fixture
def flight():
    rec = FlightRecorder(capacity=4096)
    prev = obs_trace.set_recorder(rec)
    yield rec
    obs_trace.set_recorder(prev)


def extract(scene):
    return engine.extract_features_multi(*scene, PAPER_ALGORITHMS, CFG,
                                         device="cpu")


def stage(name):
    return name.split(".")[1]


def test_stage_ranges_under_the_profiler(scene):
    """Names, counts and nesting of the profiler's ranges: response,
    select and describe inside the map, the map and the reduces inside
    the extract."""
    assert not obs_trace.enabled()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        extract(scene)
    ranges = [e for e in prof.events() if e.name.startswith("difet.")]
    assert collections.Counter(e.name for e in ranges) == EXPECTED
    assert sum(EXPECTED.values()) == 25
    by_stage = collections.Counter(stage(e.name) for e in ranges)
    assert by_stage == {"extract": 1, "map": 1, "response": 5, "select": 7,
                        "describe": 4, "reduce": 7}
    want_parent = {"extract": None, "map": "difet.extract",
                   "response": "difet.map", "select": "difet.map",
                   "describe": "difet.map", "reduce": "difet.extract"}
    for e in ranges:
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("difet."):
            parent = parent.cpu_parent
        got = None if parent is None else parent.name
        assert got == want_parent[stage(e.name)], e.name
        if parent is not None:
            assert (parent.time_range.start <= e.time_range.start
                    and e.time_range.end <= parent.time_range.end), e.name


def test_recorder_links_parents_and_one_trace_id_a_call(scene, flight):
    extract(scene)
    first = flight.spans()
    extract(scene)
    second = flight.spans()[len(first):]
    for spans in (first, second):
        assert collections.Counter(s.name for s in spans) == EXPECTED
        assert {s.layer for s in spans} == {"engine"}
        [root] = [s for s in spans if s.name == "difet.extract"]
        [mapped] = [s for s in spans if s.name == "difet.map"]
        assert root.trace_id and root.parent_id == ""
        assert {s.trace_id for s in spans} == {root.trace_id}
        assert mapped.parent_id == root.span_id
        for s in spans:
            if stage(s.name) in ("response", "select", "describe"):
                assert s.parent_id == mapped.span_id, s.name
                assert dict(s.attrs) == {"tiles": 16, "k": 32}, s.name
            elif stage(s.name) == "reduce":
                assert s.parent_id == root.span_id, s.name
                assert dict(s.attrs) == {"stage": "one"}, s.name
            inner = root if s is not root else s
            assert inner.t0 <= s.t0 <= s.t1 <= inner.t1, s.name
        assert dict(root.attrs) == {"algorithms": ",".join(PAPER_ALGORITHMS),
                                    "tiles": 16, "tile_hw": "80x80"}
    assert first[0].trace_id != second[0].trace_id
    assert len({s.span_id for s in first + second}) == 50


def test_request_reduce_spans(scene, flight):
    engine.extract_request_features(*scene, ("fast", "orb"), CFG,
                                    device="cpu")
    spans = flight.spans()
    assert collections.Counter(s.name for s in spans) == {
        "difet.extract": 1, "difet.map": 1, "difet.response.fast": 1,
        "difet.select.fast": 1, "difet.select.orb": 1,
        "difet.describe.orb": 1, "difet.reduce.fast": 1,
        "difet.reduce.orb": 1}
    assert {dict(s.attrs)["stage"] for s in spans
            if s.name.startswith("difet.reduce.")} == {"requests"}


def test_untraced_spans_enter_nothing_and_bits_equal_traced(scene,
                                                            monkeypatch):
    """With no profiler and the recorder off, ``span`` enters no
    ``record_function`` and reads no clock; a traced run (profiler and
    recorder on) returns the same bits."""
    def refuse(*args, **kwargs):
        raise AssertionError("span did work while tracing was off")

    assert isinstance(obs_trace.get_recorder(), NoopRecorder)
    with monkeypatch.context() as m:
        m.setattr(obs_trace, "record_function", refuse)
        m.setattr(obs_trace, "time", types.SimpleNamespace(monotonic=refuse))
        m.setattr(obs_trace, "new_span_id", refuse)
        untraced = extract(scene)
    rec = FlightRecorder()
    prev = obs_trace.set_recorder(rec)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            traced = extract(scene)
    finally:
        obs_trace.set_recorder(prev)
    assert len(rec.spans()) == 25
    for alg, res in untraced.items():
        assert res.keys() == traced[alg].keys()
        for key, v in res.items():
            assert v.dtype == traced[alg][key].dtype, (alg, key)
            assert torch.equal(v, traced[alg][key]), (alg, key)


def test_mesh_spans_close_on_their_thread_in_order(scene, flight,
                                                   monkeypatch):
    """On a mesh of two CPU entries `MeshRunner` steps each entry's map in
    turn: every range closes on the thread that opened it, innermost
    first, and every span of the call links to the call's span."""
    stacks = collections.defaultdict(list)
    opened = collections.Counter()

    class Range:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            stacks[threading.get_ident()].append(self.name)
            opened[self.name] += 1

        def __exit__(self, *exc):
            top = stacks[threading.get_ident()].pop()
            assert top == self.name, (top, self.name)

    monkeypatch.setattr(obs_trace, "record_function", Range)
    monkeypatch.setattr(obs_trace, "_profiler_enabled", lambda: True)
    run = engine.make_distributed_multi_extractor(PAPER_ALGORITHMS, CFG,
                                                  Mesh(["cpu"] * 2))
    got = run(*scene)
    monkeypatch.undo()
    assert all(not s for s in stacks.values())
    spans = flight.spans()
    want = collections.Counter()
    for name, n in EXPECTED.items():
        if stage(name) in ("response", "select", "describe"):
            want[name] = 2 * n
    for alg in PAPER_ALGORITHMS:
        want[f"difet.reduce.{alg}"] = 3      # two local, one merge
    want["difet.extract"] = 1
    assert collections.Counter(s.name for s in spans) == want == opened
    [root] = [s for s in spans if s.name == "difet.extract"]
    assert {s.trace_id for s in spans} == {root.trace_id}
    for s in spans:
        if s is not root:
            assert s.parent_id == root.span_id, s.name
            assert s.thread == root.thread
            assert root.t0 <= s.t0 <= s.t1 <= root.t1, s.name
    assert sorted(dict(s.attrs)["stage"] for s in spans
                  if s.name == "difet.reduce.sift") == ["local", "local",
                                                         "merge"]
    # the spans did not change the answer
    want_res = extract(scene)
    for alg, res in got.items():
        for key, v in res.items():
            assert torch.equal(v, want_res[alg][key]), (alg, key)
