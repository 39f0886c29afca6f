"""The comparison that decides ``correct``: a scene's result from the system
under test against the plain reference's, field by field.

Every number is a count or a gap over all requested algorithms; a run is
correct when each is at most its limit.  PERF.md gives the readings each
limit was set from: the largest that sound runs of the program gave over a
dozen seeds and more, and the smallest that the control (the reference in
bfloat16 put in the program's place) gave.
"""
from __future__ import annotations

import torch

# name: (limit, what it counts)
LIMITS = {
    "counts_off": (0, "per-tile counts, totals and keypoint counts unequal"),
    "keypoints_off": (0, "top-K slots whose y, x or valid flag differ"),
    "bits_off": (0, "packed BRIEF/ORB words unequal at the same keypoint"),
    "score_gap": (1e-5, "largest |score gap| at the same keypoint, over "
                        "the algorithm's largest |score|"),
    "desc_gap": (1e-5, "largest |gap| of a SIFT/SURF descriptor element "
                       "at the same keypoint"),
}
ZERO = {"counts_off": 0, "keypoints_off": 0, "bits_off": 0,
        "score_gap": 0.0, "desc_gap": 0.0}


def _pair(a, b):
    """Both tensors cut to their common leading length, and how many
    entries one has beyond the other."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    n = min(a.shape[0], b.shape[0])
    return a[:n], b[:n], abs(a.shape[0] - b.shape[0])


def _same_keypoints(res, ref):
    """(index into ``res``, index into ``ref``) of the valid top-K
    keypoints that both hold at the same scene position."""
    def keys(r):
        valid = torch.as_tensor(r["top_valid"]).bool()
        idx = torch.nonzero(valid).flatten()
        k = (torch.as_tensor(r["top_ys"]).long()[idx] * 2 ** 32
             + torch.as_tensor(r["top_xs"]).long()[idx])
        return k, idx
    gk, gi = keys(res)
    rk, ri = keys(ref)
    if not len(gk) or not len(rk):
        return gi[:0], ri[:0]
    order = torch.argsort(gk)
    gk, gi = gk[order], gi[order]
    pos = torch.searchsorted(gk, rk).clamp(max=len(gk) - 1)
    hit = gk[pos] == rk
    return gi[pos][hit], ri[hit]


def numbers(got: dict, want: dict) -> dict:
    """{number: value} of one scene: ``got`` and ``want`` are {algorithm:
    {field: tensor on the host}}, ``want`` the reference's.  Counts and
    the top-K's slots are compared as they stand; scores and descriptors
    at each keypoint that both hold, wherever it sits in the top-K."""
    out = dict(ZERO)
    for alg, ref in want.items():
        res = got.get(alg)
        if res is None:
            out["counts_off"] += ref["per_tile_count"].numel() + 2
            out["keypoints_off"] += ref["top_ys"].numel()
            continue
        a, b, extra = _pair(res["per_tile_count"], ref["per_tile_count"])
        out["counts_off"] += int((a.long() != b.long()).sum()) + extra
        for key in ("total_count", "keypoint_count"):
            out["counts_off"] += int(int(res[key]) != int(ref[key]))
        same = None
        for key in ("top_ys", "top_xs", "top_valid"):
            a, b, extra = _pair(res[key], ref[key])
            eq = a.long() == b.long()
            same = eq if same is None else same & eq
        out["keypoints_off"] += int((~same).sum()) + extra
        gi, ri = _same_keypoints(res, ref)
        if not len(ri):
            continue
        b = torch.as_tensor(ref["top_scores"]).double()
        a = torch.as_tensor(res["top_scores"]).double()[gi]
        scale = float(b[ri].abs().max()) or 1.0
        out["score_gap"] = max(out["score_gap"],
                               float((a - b[ri]).abs().max()) / scale)
        if "top_desc" not in ref:
            continue
        a = torch.as_tensor(res["top_desc"])[gi]
        b = torch.as_tensor(ref["top_desc"])[ri]
        if not b.is_floating_point():
            out["bits_off"] += int((a.long() != b.long()).sum())
        else:
            out["desc_gap"] = max(out["desc_gap"], float(
                (a.double() - b.double()).abs().max()))
    return out


def worst(readings) -> dict:
    """The largest value of each number over several scenes' readings."""
    out = dict(ZERO)
    for r in readings:
        for name, v in r.items():
            out[name] = max(out[name], v)
    return out


def verdict(values: dict) -> bool:
    return all(values[name] <= limit for name, (limit, _) in LIMITS.items())


def report(values: dict) -> dict:
    """{number: {"value": v, "limit": l}} for the result's line."""
    return {name: {"value": values[name], "limit": limit}
            for name, (limit, _) in LIMITS.items()}
