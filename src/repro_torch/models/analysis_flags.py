"""Analysis-mode flags (port of ``repro.models.analysis_flags``).

``single_chunk()``: the reference's roofline correction pass sets it so that
every time-axis chunked scan (online-softmax attention, SSD chunks, mLSTM
chunks) is unrolled and counted in full.  The port's chunk loops are Python
loops, which `launch.analysis.OpCounter` counts in full already, so no
numerics read the flag; `launch.correction.measure` sets it, as the
reference's does.

``card_routes()``: the layers take the card's routes (a bf16 GEMM with fp32
accumulation, ``MatmulF32``) on tensors of any device, so that the dry run
counts the card's program on fake CPU tensors where torch has no CUDA.
Only a trace on fake tensors sets it: a CPU has no such GEMM.
"""
from __future__ import annotations

import contextlib
import threading

_state = threading.local()


def single_chunk_active() -> bool:
    return getattr(_state, "single_chunk", False)


@contextlib.contextmanager
def single_chunk():
    prev = getattr(_state, "single_chunk", False)
    _state.single_chunk = True
    try:
        yield
    finally:
        _state.single_chunk = prev


def card_routes_active() -> bool:
    return getattr(_state, "card_routes", False)


@contextlib.contextmanager
def card_routes():
    prev = getattr(_state, "card_routes", False)
    _state.card_routes = True
    try:
        yield
    finally:
        _state.card_routes = prev
