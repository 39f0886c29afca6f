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
