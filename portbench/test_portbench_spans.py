"""The readers of the program's spans (``metrics/span.py``: ``<stage>_span``;
``metrics/engine_idle_ms.py``) on a hand-built `Trace`, and the program's
``difet.*`` spans reaching the harness's trace on the CPU."""
import collections
import random

import pytest

from portbench import profiling, run
from portbench.metrics import span

NAMES = ("response_span", "select_span", "describe_span", "reduce_span",
         "engine_idle_ms")


def make_trace(host, device, scenes=2, window=(0.0, 1000.0), cards=None):
    """A `Trace` without a profiler: ``host`` is [(name, start us, end us)
    or (name, start, end, correlation id)], ``device`` [(name, start, end,
    id) or (name, start, end, id, card)]; device names starting with
    Memcpy or Memset are copies."""
    host = [h if len(h) == 4 else (*h, 0) for h in host]
    acts = [(n, s, t, d[4] if len(d) > 4 else 0, 0, i)
            for d in device for n, s, t, i in [d[:4]]]
    return profiling.Trace(window, [h[:3] for h in host], acts, scenes,
                           cards=cards, host_ids=[h[3] for h in host])


SPANS = [("difet.extract", 10.0, 800.0), ("difet.map", 20.0, 600.0),
         ("difet.response.harris", 30.0, 100.0),
         ("difet.select.harris", 100.0, 300.0),
         ("difet.describe.orb", 300.0, 500.0),
         ("difet.reduce.harris", 610.0, 700.0)]
# launching runtime calls with their correlation ids, and host work that
# launches nothing
LAUNCHES = [("cudaLaunchKernel", 40.0, 42.0, 101),
            ("cudaLaunchKernel", 50.0, 52.0, 102),
            ("cudaMemsetAsync", 150.0, 151.0, 103),
            ("cuLaunchKernel", 200.0, 203.0, 104),
            ("cudaMemcpyAsync", 550.0, 551.0, 105),
            ("cudaLaunchKernelExC", 620.0, 622.0, 106),
            ("cudaMemcpyAsync", 950.0, 952.0, 107)]
OTHERS = [("aten::add", 39.0, 45.0, 7), ("cudaStreamSynchronize", 560.0,
                                        580.0, 108),
          ("cudaEventRecord", 630.0, 631.0, 109)]
# in device order, with their launches' ids; each runs well after its
# launch, so that overlapping host and device times would give other
# answers
DEVICE = [("k_resp_a", 100.0, 140.0, 101), ("k_resp_b", 140.0, 150.0, 102),
          ("Memset (Device)", 300.0, 301.0, 103),
          ("k_select", 350.0, 450.0, 104),
          ("Memcpy DtoD (Device -> Device)", 560.0, 566.0, 105),
          ("k_reduce", 700.0, 720.0, 106),
          ("Memcpy DtoH (Device -> Pageable)", 955.0, 960.0, 107)]


def full_trace(**kw):
    return make_trace(SPANS + LAUNCHES + OTHERS, DEVICE, **kw)


def read_all(trace):
    return {name: run.reader(name)(trace) for name in NAMES}


def test_launches_pair_with_activities_in_order_and_innermost_span():
    got = read_all(full_trace())
    # us over 2 scenes, in ms: response 40 + 10, select 1 + 100 (the
    # launch at 200 is in select, though its kernel runs in describe's
    # host time), describe launches nothing, reduce 20; the map's copy
    # and the copy after the extract count in no stage
    assert got["response_span"] == pytest.approx(50e-3 / 2)
    assert got["select_span"] == pytest.approx(101e-3 / 2)
    assert got["describe_span"] == 0.0
    assert got["reduce_span"] == pytest.approx(20e-3 / 2)
    seconds = span.attribute(full_trace())
    assert seconds == pytest.approx({
        "difet.response.harris": 50e-6, "difet.select.harris": 101e-6,
        "difet.map": 6e-6, "difet.reduce.harris": 20e-6, None: 5e-6})


def test_counts_that_differ_read_nothing():
    """An activity whose launch is not in the window (by its correlation
    id) reads nothing."""
    for host, device in ((SPANS + LAUNCHES[1:], DEVICE),
                         (SPANS + LAUNCHES, DEVICE + [("k_late", 970.0,
                                                       980.0, 999)])):
        got = read_all(make_trace(host, device))
        assert got["engine_idle_ms"] is not None
        assert [got[n] for n in NAMES[:4]] == [None] * 4


def test_a_launch_whose_activity_was_lost_pairs_with_nothing():
    """The profiler lost an activity (a launch without its kernel): the
    others still pair by id and read, where the n-th pairing read
    nothing."""
    got = read_all(make_trace(SPANS + LAUNCHES, DEVICE[:3] + DEVICE[4:]))
    assert got["select_span"] == pytest.approx(1e-3 / 2)
    assert got["response_span"] == pytest.approx(50e-3 / 2)
    assert got["reduce_span"] == pytest.approx(20e-3 / 2)


def test_two_cards_interleaved_pair_by_id():
    """Two cards' activities interleave in another order than their
    launches: pairing by id attributes each to its own launch's span,
    where the n-th launch paired with the n-th activity would not."""
    host = SPANS + [("cudaLaunchKernel", 40.0, 41.0, 1),     # card 0
                    ("cudaLaunchKernel", 60.0, 61.0, 2),     # card 1
                    ("cudaLaunchKernel", 120.0, 121.0, 3),   # card 0
                    ("cudaLaunchKernel", 310.0, 311.0, 4)]   # card 1
    device = [("k_resp0", 45.0, 300.0, 1, 0),
              ("k_sel1", 150.0, 160.0, 3, 0),
              ("k_desc1", 320.0, 330.0, 4, 1),
              ("k_resp1", 400.0, 500.0, 2, 1)]
    tr = make_trace(host, device, cards=[0, 1])
    seconds = span.attribute(tr)
    assert seconds == pytest.approx({
        "difet.response.harris": (255 + 100) * 1e-6,
        "difet.select.harris": 10e-6, "difet.describe.orb": 10e-6})
    # by start order instead: k_resp0, k_sel1, k_desc1, k_resp1 against
    # the launches at 40, 60, 120, 310
    by_order = collections.Counter()
    for (_, s, _, _), (_, a, b, _, _) in zip(host[len(SPANS):], device):
        name = span.innermost(span.program_spans(tr), [s])[0]
        by_order[name] += (b - a) * 1e-6
    assert dict(by_order) == pytest.approx({
        "difet.response.harris": 265e-6, "difet.select.harris": 10e-6,
        "difet.describe.orb": 100e-6})


def test_a_program_without_spans_or_a_trace_without_device_reads_nothing():
    """The parent program (no ``difet.*`` span), or the CPU (no device
    activity): every reader returns None and none raises."""
    assert set(read_all(make_trace(LAUNCHES + OTHERS, DEVICE)).values()) \
        == {None}
    assert set(read_all(make_trace(SPANS + OTHERS, [])).values()) == {None}
    # a stage with no span at all reads nothing, not 0
    assert run.reader("describe_span")(make_trace(
        [s for s in SPANS if "describe" not in s[0]] + LAUNCHES,
        DEVICE)) is None


def test_engine_idle_counts_the_gaps_inside_program_spans():
    tr = full_trace()
    # gaps (us): 0-100 mid in response, 150-300 in select, 301-350 in
    # describe, 450-560 in the map, 566-700 in reduce; 720-955 (mid 837.5)
    # and 960-1000 lie after the extract
    assert run.reader("engine_idle_ms")(tr) == pytest.approx(
        (100 + 150 + 49 + 110 + 134) * 1e-3 / 2)
    named = collections.Counter()
    for name, seconds in tr.breakdown(top=20)["idle_gaps"]:
        named[name] += seconds
    assert named["python"] == pytest.approx((235 + 40) * 1e-6)
    assert named["difet.select.harris"] == pytest.approx(150e-6)


def laminar(rng, lo, hi, depth, out):
    """Random nested spans inside [lo, hi), each child inside its parent."""
    t = lo
    while depth and t < hi - 4:
        s = rng.uniform(t, hi - 2)
        e = rng.uniform(s + 1, hi)
        out.append((f"difet.s{len(out)}", s, e))
        laminar(rng, s, e, depth - 1, out)
        t = e + rng.uniform(0, 3)
    return out


@pytest.mark.parametrize("seed", range(8))
def test_innermost_is_the_shortest_span_that_holds_the_time(seed):
    rng = random.Random(seed)
    spans = sorted(laminar(rng, 0.0, 1000.0, 4, []),
                   key=lambda h: (h[1], -h[2]))
    times = sorted(rng.uniform(-10, 1010) for _ in range(400))
    want = []
    for t in times:
        holding = [h for h in spans if h[1] <= t < h[2]]
        want.append(min(holding, key=lambda h: h[2] - h[1])[0]
                    if holding else None)
    assert span.innermost(spans, times) == want


def test_the_programs_spans_reach_the_harness_trace(tiny_cfg, tiny_traffic):
    """On the CPU the traced window holds every ``difet.*`` span of each
    scene (no device activity there, so the readers read nothing)."""
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    e2e, per_layer = run.cell_metrics(bench, "paper-t512.all7")
    assert set(NAMES) <= {m["name"] for m in per_layer}
    entry = run.program_entry(tiny_cfg, tiny_traffic["algorithms"])
    out, _ = run.measure(tiny_cfg, tiny_traffic, 5, 0.01, True, "cpu",
                         entry, e2e, per_layer)
    assert out["correct"]
    names = collections.Counter(n for n, _, _ in out["trace"].host
                                if n.startswith("difet."))
    stages = collections.Counter(n.split(".")[1] for n in names.elements())
    assert stages == {"extract": 2, "map": 2, "response": 10, "select": 14,
                      "describe": 8, "reduce": 14}
    assert not set(NAMES) & set(out["metrics"])
