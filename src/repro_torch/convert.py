"""Carry the JAX reference's state across to the port.

The main path learns nothing, so its state is the configuration and the
fixed BRIEF sampling pattern; the matching path adds the approximate
indexes' hash positions, centroids and inverted lists; the LM substrate's
state is the parameter tree of a reference model's ``init``.  All arrive as
plain Python/numpy values (``dataclasses.asdict`` of the reference config,
the reference's ``brief_pairs`` array, an index's arrays, nested dicts of
numpy arrays), so this module needs nothing of the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.difet_paper import DifetConfig
from repro_torch.core.descriptors import brief_pairs
from repro_torch.kernels.index import KMeansIndex, LshIndex
from repro_torch.models import build_model


def config_from_reference(d: dict) -> DifetConfig:
    """``DifetConfig`` from ``dataclasses.asdict`` of the reference's config;
    unknown or missing fields raise."""
    names = {f.name for f in dataclasses.fields(DifetConfig)}
    unknown = set(d) - names
    missing = names - set(d)
    if unknown or missing:
        raise ValueError(f"config fields differ from the port's: unknown "
                         f"{sorted(unknown)}, missing {sorted(missing)}")
    return DifetConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in d.items()})


def brief_pairs_from_reference(a: np.ndarray, patch: int = 31,
                               device="cpu") -> torch.Tensor:
    """The reference's BRIEF pattern ``int32 [n_bits, 4]`` for ``patch``,
    checked against the port's own copy (same ``RandomState(7)`` draw),
    as a tensor."""
    a = np.asarray(a)
    if a.ndim != 2 or a.shape[1] != 4:
        raise ValueError(f"BRIEF pattern must be [n_bits, 4], got {a.shape}")
    own = brief_pairs(a.shape[0], patch)
    if not np.array_equal(own, a.astype(np.int32)):
        raise ValueError("BRIEF pattern differs from the port's own "
                         "brief_pairs; descriptors would not match")
    return torch.from_numpy(own.copy()).to(device)


def lsh_from_reference(db, db_valid, word: np.ndarray, shift: np.ndarray,
                       lists: np.ndarray, probes=None) -> LshIndex:
    """The port's ``LshIndex`` over ``db`` (packed words, uint32 or int32;
    the index lives on a tensor's device) from a reference ``LshIndex``'s
    ``_word``, ``_shift`` and lists, as numpy, so that both search
    identical candidate sets."""
    word, shift, lists = (np.asarray(a) for a in (word, shift, lists))
    if word.shape != shift.shape or lists.ndim != 3 \
            or lists.shape[:2] != (word.shape[0], 2 ** word.shape[1]):
        raise ValueError(f"LSH state shapes disagree: word {word.shape}, "
                         f"shift {shift.shape}, lists {lists.shape}")
    return LshIndex.from_state(db, db_valid, word, shift, lists,
                               probes=probes)


def kmeans_from_reference(db, db_valid, centroids: np.ndarray,
                          lists: np.ndarray,
                          probes: int = 8) -> KMeansIndex:
    """The port's ``KMeansIndex`` over ``db`` from a reference
    ``KMeansIndex``'s centroids and lists, as numpy."""
    centroids, lists = np.asarray(centroids), np.asarray(lists)
    if lists.ndim != 2 or lists.shape[0] != centroids.shape[0]:
        raise ValueError(f"k-means state shapes disagree: centroids "
                         f"{centroids.shape}, lists {lists.shape}")
    return KMeansIndex.from_state(db, db_valid, centroids, lists,
                                  probes=probes)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16 from JAX
        return torch.from_numpy(np.array(a).view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def load_reference_tree(module: torch.nn.Module, tree: dict):
    """Copy a reference parameter tree (nested dicts of numpy arrays, as the
    reference's ``init`` returns them) into ``module``'s parameters.

    The port names each parameter by the reference's path with the stacked
    axes spelled out: ``stack.3.attn.wq`` is layer 3 of the reference's
    ``stack/attn/wq`` [L, ...]; ``stack.1.mlstm.4.wq`` is [1, 4] of xLSTM's
    ``stack/mlstm/wq`` [g, n, ...].  Both keep the reference's layouts
    (``[in, out]`` projections), so nothing is transposed.  A port
    parameter with no reference leaf, a reference leaf (or a slice of one)
    that no port parameter takes, or a shape or dtype that differs raises.
    Returns ``module``."""
    leaves = _flatten(tree)
    used = {path: set() for path in leaves}
    with torch.no_grad():
        for name, p in module.named_parameters():
            parts = name.split(".")
            idx = tuple(int(x) for x in parts if x.isdigit())
            path = "/".join(x for x in parts if not x.isdigit())
            if path not in leaves:
                raise ValueError(f"no reference leaf {path!r} for {name!r}")
            a = leaves[path]
            if a.ndim < len(idx) or any(i >= n for i, n in
                                        zip(idx, a.shape)):
                raise ValueError(f"{name!r}: index {idx} outside the "
                                 f"reference's {path!r} {a.shape}")
            a = a[idx]
            src = _tensor(a)
            if tuple(src.shape) != tuple(p.shape) or src.dtype != p.dtype:
                raise ValueError(
                    f"{name!r}: the reference's {path!r} slice is "
                    f"{tuple(src.shape)} {src.dtype}, the port's "
                    f"{tuple(p.shape)} {p.dtype}")
            p.copy_(src)
            used[path].add(idx)
    for path, seen in used.items():
        if not seen:
            raise ValueError(f"the port has no parameter for the "
                             f"reference's {path!r}")
        n = len(next(iter(seen)))
        if len(seen) != int(np.prod(leaves[path].shape[:n])):
            raise ValueError(f"the port takes {len(seen)} slices of the "
                             f"reference's {path!r} "
                             f"{leaves[path].shape}, not all of them")
    return module


def lm_params_from_reference(cfg, params: dict, device=None):
    """The port's model of ``cfg`` (``build_model``: the card unless
    ``device="cpu"``) holding the reference's ``model.init(...)`` tree
    ``params`` (numpy arrays)."""
    return load_reference_tree(build_model(cfg, device), params)
