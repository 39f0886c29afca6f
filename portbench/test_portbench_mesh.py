"""A cell of more than one card (``chips`` > 1): the harness over a mesh
of four CPU entries (``Mesh(["cpu"] * 4)``, the program's split and merge
with its kernels as their plain twins) against the one-entry run, and the
per-card readings of hand-built traces: busy and idle card by card, the
cards' skew, and the idle gaps named by card.  ~25 s in one process."""
import pytest
import torch

from portbench import profiling, run
from repro_torch.distributed.sharding import Mesh, Sharded


def _recorded(entry, log):
    def recorded(tiles, headers):
        res = entry(tiles, headers)
        log.append(run.to_host(res))
        return res
    return recorded


def test_the_mesh_run_is_correct_and_equals_one_entry(tiny_cfg,
                                                      tiny_traffic):
    """Over four entries the pool is staged as `Sharded` batches, the run
    is correct, and every scene's answer (the warm scene and the traced
    ones) equals the one-entry run's bit for bit.  The metrics are the
    paper cell's, which a cell of the same scene over four cards reads."""
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    e2e, per_layer = run.cell_metrics(bench, "paper-t512.all7")
    algs = tiny_traffic["algorithms"]
    mesh = Mesh(["cpu"] * 4)
    pool = run.make_pool(tiny_cfg, tiny_traffic, 9, "cpu", mesh)
    tiles, headers = pool[0]
    assert isinstance(tiles, Sharded) and isinstance(headers, Sharded)
    # 9 tiles over 4 entries, 3 2 2 2, none a view of the whole scene
    assert [len(p) for p in tiles.parts] == [3, 2, 2, 2]
    one = run.make_pool(tiny_cfg, tiny_traffic, 9, "cpu")[0]
    assert torch.equal(run.whole(tiles, "cpu"), one[0])
    assert torch.equal(run.whole(headers, "cpu"), one[1])
    logs = {}
    for name, m in (("mesh", mesh), ("one", None)):
        logs[name] = []
        entry = _recorded(run.program_entry(tiny_cfg, algs, m), logs[name])
        out, values = run.measure(tiny_cfg, tiny_traffic, 9, 0.01, True,
                                  "cpu", entry, e2e, per_layer, mesh=m)
        assert out["correct"], values
        assert out["attempted"] == tiny_traffic["trace_scenes"]
        # no device on the CPU: no per-layer metric of the cell reads
        assert out["metrics"] == {}
        assert "memory_peak_bytes_per_card" not in out
    assert len(logs["mesh"]) == len(logs["one"]) == 3
    for got, want in zip(logs["mesh"], logs["one"]):
        assert set(got) == set(want) == set(algs)
        for alg in algs:
            assert set(got[alg]) == set(want[alg])
            for key in want[alg]:
                assert torch.equal(got[alg][key], want[alg][key]), (alg, key)


def test_a_cell_of_more_than_one_card_asks_for_the_programs_mesh():
    """One card: no mesh; four: the program's ``data_mesh(4)``, which
    refuses a host without cards."""
    assert run.cell_mesh({"chips": 1}) is None
    with pytest.raises(RuntimeError, match="no CUDA card"):
        run.cell_mesh({"chips": 4})


def _trace(device, cards, host=(), scenes=2):
    """A hand-built `Trace` over 0-1000 us: ``device`` is [(name, start,
    end, card)]."""
    acts = [(n, s, t, c, 7, i + 1) for i, (n, s, t, c) in enumerate(device)]
    return profiling.Trace((0.0, 1000.0), list(host), acts, scenes,
                           cards=cards)


FOUR = [("k", 0.0, 600.0, 0), ("Memcpy PtoP", 600.0, 700.0, 0),
        ("k", 100.0, 500.0, 1), ("k", 450.0, 550.0, 1),
        ("k", 0.0, 250.0, 2), ("k", 750.0, 1000.0, 2)]


def test_busy_and_idle_are_read_card_by_card():
    """Busy 700, 450, 500 and 0 us on four cards: the trace's busy is
    their mean, idle the mean of the cards' idle, the skew (700 - 0) /
    700; the cards merged into one timeline would read 950 us busy."""
    tr = _trace(FOUR, cards=[0, 1, 2, 3])
    assert tr.card_busy_s() == pytest.approx(
        {0: 700e-6, 1: 450e-6, 2: 500e-6, 3: 0.0})
    assert tr.busy_s == pytest.approx(1650e-6 / 4)
    assert sum(t - s for s, t in tr.busy()) == pytest.approx(950.0)
    assert run.reader("device_idle_pct")(tr) == pytest.approx(
        100.0 * (1 - 1650 / 4000))
    assert run.reader("card_skew_pct")(tr) == pytest.approx(100.0)
    three = _trace(FOUR, cards=[0, 1, 2])
    assert run.reader("card_skew_pct")(three) == pytest.approx(
        100.0 * (700 - 450) / 700)
    assert tr.gaps(1) == [(0.0, 100.0), (550.0, 1000.0)]
    assert tr.gaps(3) == [(0.0, 1000.0)]


def test_one_card_reads_as_before():
    """On one card the skew reads nothing, and the idle gaps keep their
    names as the host ran at their middle, with no card's prefix."""
    tr = _trace([(n, s, t, 0) for n, s, t, _ in FOUR], cards=[0],
                host=[("aten::copy_", 700.0, 760.0)])
    assert run.reader("card_skew_pct")(tr) is None
    assert tr.busy_s == pytest.approx(950e-6)       # 0-700, 750-1000
    gaps = tr.breakdown()["idle_gaps"]
    assert gaps == [["aten::copy_", pytest.approx(50e-6)]]


def test_gaps_of_several_cards_name_their_card():
    host = [("difet.extract", 0.0, 900.0), ("difet.select.orb", 560.0,
                                             800.0)]
    tr = _trace(FOUR, cards=[0, 1, 2, 3], host=host)
    gaps = tr.breakdown(top=3)["idle_gaps"]
    # card 3 idle all 1000 us (middle at 500: the extract); card 2 250-750
    # (middle 500); card 1 550-1000 (middle 775: ORB's selection)
    assert gaps == [["cuda:3 difet.extract", pytest.approx(1000e-6)],
                    ["cuda:2 difet.extract", pytest.approx(500e-6)],
                    ["cuda:1 difet.select.orb", pytest.approx(450e-6)]]
    # the engine's idle: the gaps whose middle lies in a difet.* span,
    # card by card, the mean over the four, a scene of two
    assert run.reader("engine_idle_ms")(tr) == pytest.approx(
        (300 + (100 + 450) + 500 + 1000) * 1e-3 / 4 / 2)
