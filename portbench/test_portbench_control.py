"""The comparison that decides ``correct`` fails what it must: the control
(the reference in bfloat16 in the program's place) and a run of the
harness, set-up to check, with the timed path broken underneath.  The
harness's look for a card is skipped: the program runs on the CPU, its
kernels as their plain twins."""
import pytest
import torch

from portbench import compare, run, scenes
from portbench.reference import difet as reference

ALL7 = ("harris", "shi_tomasi", "sift", "surf", "fast", "brief", "orb")


def _tiles(cfg, seed):
    gray = scenes.synthetic_scene(*cfg["scene_hw"],
                                  scenes.generator(seed, "cpu"))
    return scenes.tile_scene(gray, cfg["tile"], cfg["halo"])


@pytest.mark.parametrize("seed", [5, 2 ** 31 + 11, 2 ** 40 + 3])
def test_control_is_not_correct_and_the_program_is(tiny_cfg, seed):
    tiles, headers = _tiles(tiny_cfg, seed)
    want = reference.extract(tiles, headers, ALL7, tiny_cfg)
    control = reference.extract(tiles, headers, ALL7, tiny_cfg,
                                dtype=torch.bfloat16)
    program = run.to_host(run.program_entry(tiny_cfg, ALL7)(tiles, headers))
    sound = compare.numbers(program, want)
    assert compare.verdict(sound), sound
    low = compare.numbers(control, want)
    assert not compare.verdict(low), low
    # the control misses by far more than the limits on the counts
    assert low["counts_off"] > 0 and low["keypoints_off"] > 0


def _half_batch(entry):
    def broken(tiles, headers):
        n = tiles.shape[0] // 2
        return entry(tiles[:n], headers[:n])
    return broken


def _altered_answer(entry):
    def broken(tiles, headers):
        res = entry(tiles, headers)
        res["surf"]["top_ys"] = res["surf"]["top_ys"].clone()
        res["surf"]["top_ys"][0] += 1
        return res
    return broken


def _stale(entry):
    first = {}

    def broken(tiles, headers):
        if not first:
            first.update(entry(tiles, headers))
        return first
    return broken


@pytest.mark.parametrize("fault,trace", [
    (None, False), (_half_batch, False), (_altered_answer, False),
    (_stale, False), (None, True), (_altered_answer, True)])
def test_a_run_with_the_timed_path_broken_is_not_correct(
        tiny_cfg, tiny_traffic, fault, trace):
    entry = run.program_entry(tiny_cfg, tiny_traffic["algorithms"])
    if fault is not None:
        entry = fault(entry)
    out, values = run.measure(tiny_cfg, tiny_traffic, 2 ** 31 + 5, 0.05,
                              trace, "cpu", entry)
    assert out["attempted"] >= 2 and out["compared_scenes"] >= 2
    assert out["correct"] is (fault is None), values


def _exchange_left_out(monkeypatch):
    """The merge on the first card takes its own entry's candidates only:
    what the other cards found never crosses."""
    from repro_torch.core import engine
    merge = engine.merge_reduced
    monkeypatch.setattr(engine, "merge_reduced",
                        lambda parts, k: merge(parts[:1], k))


@pytest.mark.parametrize("fault", [None, "exchange", _altered_answer,
                                   _stale])
def test_a_mesh_run_with_the_timed_path_broken_is_not_correct(
        tiny_cfg, tiny_traffic, monkeypatch, fault):
    """The same over a mesh of four entries (a cell of four cards), with
    the exchange between the entries left out besides."""
    from repro_torch.distributed.sharding import Mesh
    mesh = Mesh(["cpu"] * 4)
    entry = run.program_entry(tiny_cfg, tiny_traffic["algorithms"], mesh)
    if fault == "exchange":
        _exchange_left_out(monkeypatch)
    elif fault is not None:
        entry = fault(entry)
    out, values = run.measure(tiny_cfg, tiny_traffic, 2 ** 33 + 1, 0.05,
                              False, "cpu", entry, mesh=mesh)
    assert out["attempted"] >= 2 and out["compared_scenes"] >= 2
    assert out["correct"] is (fault is None), values


def test_the_landing_keeps_a_seeded_sample_of_each_checked_slot():
    """Each checked slot keeps at most ``per_slot`` of its scenes, drawn
    from the seed over the whole window; every scene's answer reads back
    as it was produced, a field of another shape in a tensor of its own."""
    like = {"a": {"x": torch.zeros(3), "n": torch.tensor(0)}}

    def kept(seed):
        landing = run.Landing(like, {1, 2}, seed, per_slot=4)
        for i in range(40):
            got = landing(i % 4, {"a": {"x": torch.full((3,), float(i)),
                                        "n": torch.tensor(i)}})
            assert int(got["a"]["n"]) == i
            assert torch.equal(got["a"]["x"], torch.full((3,), float(i)))
        return [(s, int(r["a"]["n"])) for s, r in landing.items()]

    first = kept(2 ** 31 + 7)
    assert first == kept(2 ** 31 + 7) and first != kept(2 ** 31 + 8)
    assert len(first) == 8 and {s for s, _ in first} == {1, 2}
    assert all(n % 4 == s for s, n in first)
    assert max(n for _, n in first) >= 16          # not the first four
    landing = run.Landing(like, {0}, 1, per_slot=2)
    got = landing(0, {"a": {"x": torch.ones(5), "n": torch.tensor(1)}})
    assert torch.equal(got["a"]["x"], torch.ones(5))
    assert [s for s, _ in landing.items()] == [0]
