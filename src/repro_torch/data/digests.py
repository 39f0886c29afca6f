"""Digests of an extraction's exact fields, to hold one run to another tile
by tile and field by field without keeping the fields
(``reference_counts.json`` keeps the JAX reference's).

A digest is the first 16 hex digits of the sha256 of one field's
little-endian bytes: the keypoints' scene rows and columns (``ys``,
``xs``) as int32, ``valid`` as one byte each, and BRIEF's and ORB's packed
descriptors (``desc``) as uint32 words (the reference's dtype; the port
packs the same bits into int32).  Scores and float descriptors are not
exact across implementations, so they are not hashed.
"""
from __future__ import annotations

import hashlib

import numpy as np

PACKED = ("brief", "orb")           # algorithms whose descriptors are words
TOP = {"ys": "top_ys", "xs": "top_xs", "valid": "top_valid",
       "desc": "top_desc"}          # the reduce's name of each field


def fields(algorithm: str) -> tuple:
    """The exact fields of one algorithm's result."""
    return ("ys", "xs", "valid") + (("desc",) if algorithm in PACKED else ())


def _le_bytes(a, field: str) -> bytes:
    a = np.asarray(a)
    if field == "valid":
        return a.astype(np.uint8).tobytes()
    if field == "desc":
        if a.dtype == np.int32:
            a = a.view(np.uint32)
        return a.astype("<u4").tobytes()
    return a.astype("<i4").tobytes()


def digest(a, field: str) -> str:
    """The digest of one field's values (a numpy array, or a tensor on the
    host)."""
    return hashlib.sha256(_le_bytes(a, field)).hexdigest()[:16]


def tile_digests(per_tile: dict, algorithm: str) -> dict:
    """{field: [digest of each tile]} of one algorithm's map output (each
    field [T, K, ...] on the host)."""
    return {f: [digest(t, f) for t in np.asarray(per_tile[f])]
            for f in fields(algorithm)}


def top_digests(result: dict, algorithm: str) -> dict:
    """{field: digest} of one algorithm's reduce (``top_ys``, ``top_xs``,
    ``top_valid`` and, for packed descriptors, ``top_desc``)."""
    return {f: digest(result[TOP[f]], f) for f in fields(algorithm)}
