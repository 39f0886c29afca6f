"""Carry the JAX reference's state across to the port.

The main path learns nothing, so its state is the configuration and the
fixed BRIEF sampling pattern.  Both arrive as plain Python/numpy values
(``dataclasses.asdict`` of the reference config, the reference's
``brief_pairs`` array), so this module needs nothing of the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.difet_paper import DifetConfig
from repro_torch.core.descriptors import brief_pairs


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
