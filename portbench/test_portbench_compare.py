"""The comparison's numbers on hand-made results."""
import pytest
import torch

from portbench import compare


def _result(ys, xs, scores, desc=None, count=(3, 2)):
    r = {"total_count": torch.tensor(sum(count)),
         "per_tile_count": torch.tensor(count, dtype=torch.int32),
         "top_ys": torch.tensor(ys, dtype=torch.int32),
         "top_xs": torch.tensor(xs, dtype=torch.int32),
         "top_scores": torch.tensor(scores),
         "top_valid": torch.tensor([s > 0 for s in scores]),
         "keypoint_count": torch.tensor(sum(s > 0 for s in scores))}
    if desc is not None:
        r["top_desc"] = torch.tensor(desc)
    return r


REF = _result([1, 5, 9, 0], [2, 6, 3, 0], [4.0, 2.0, 1.0, 0.0],
              [[0.5, 0.5], [0.25, 0.75], [1.0, 0.0], [0.0, 0.0]])


def test_equal_results_read_zero():
    v = compare.numbers({"sift": REF}, {"sift": REF})
    assert v == {"counts_off": 0, "keypoints_off": 0, "bits_off": 0,
                 "score_gap": 0.0, "desc_gap": 0.0}
    assert compare.verdict(v)


def test_a_swap_in_the_top_k_is_off_but_gaps_are_read_per_keypoint():
    got = _result([5, 1, 9, 0], [6, 2, 3, 0], [4.0, 4.0, 1.0, 0.0],
                  [[0.25, 0.75], [0.5, 0.5], [1.0, 0.0], [0.0, 0.0]])
    v = compare.numbers({"sift": got}, {"sift": REF})
    assert v["keypoints_off"] == 2 and v["desc_gap"] == 0.0
    assert v["score_gap"] == pytest.approx(0.5)     # |4 - 2| / 4
    assert not compare.verdict(v)


@pytest.mark.parametrize("field,change,number", [
    ("per_tile_count", lambda t: t + torch.tensor([0, 1], dtype=t.dtype),
     "counts_off"),
    ("top_scores", lambda t: t * (1 + 1e-3), "score_gap"),
    ("top_desc", lambda t: t + 1e-3, "desc_gap"),
    ("per_tile_count", lambda t: t[:1], "counts_off"),
])
def test_each_change_fails_its_number(field, change, number):
    got = dict(REF, **{field: change(REF[field])})
    v = compare.numbers({"sift": got}, {"sift": REF})
    assert v[number] > compare.LIMITS[number][0]
    assert not compare.verdict(v)


def test_packed_words_are_compared_at_the_same_keypoint():
    words = torch.tensor([[7], [-1], [3], [0]], dtype=torch.int32)
    ref = dict(REF, top_desc=words)
    got = dict(REF, top_desc=words.clone())
    got["top_desc"][2, 0] = 2
    v = compare.numbers({"orb": got}, {"orb": ref})
    assert v["bits_off"] == 1 and v["desc_gap"] == 0.0


def test_a_missing_algorithm_fails():
    v = compare.numbers({}, {"sift": REF})
    assert v["counts_off"] > 0 and not compare.verdict(v)
