"""Carry the JAX reference's state across to the port.

The main path learns nothing, so its state is the configuration and the
fixed BRIEF sampling pattern; the matching path adds the approximate
indexes' hash positions, centroids and inverted lists.  All arrive as plain
Python/numpy values (``dataclasses.asdict`` of the reference config, the
reference's ``brief_pairs`` array, an index's arrays), so this module needs
nothing of the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.difet_paper import DifetConfig
from repro_torch.core.descriptors import brief_pairs
from repro_torch.kernels.index import KMeansIndex, LshIndex


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
