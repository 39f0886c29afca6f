"""Analysis-mode flags (port of ``repro.models.analysis_flags``).

``single_chunk()``: the reference's roofline correction pass sets it so that
every time-axis chunked scan (online-softmax attention, SSD chunks, mLSTM
chunks) is unrolled and counted in full.  The port's chunk loops are Python
loops already, so no numerics read the flag; it is kept, thread-local as in
the reference, for the sharding and analysis slice that will count costs.
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
