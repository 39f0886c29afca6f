"""What the per-layer metrics read: a ``torch.profiler`` window over a few
scenes, reduced to device activities, host spans and the calls of the
program's hand-kernel wrappers.

The window is the host span ``portbench.window`` around the traced scenes;
device activities (kernels, copies, memsets) are clipped to it, each with
its card, its stream and the correlation id that ties it to the runtime
call that launched it.  The profiler's device timestamps are on the host's
clock, so busy and idle time are read against the same interval, card by
card.
"""
from __future__ import annotations

import contextlib
import importlib.util
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parents[1]
WINDOW = "portbench.window"
SCENE = "portbench.scene"


def work_modules(root: Path = ROOT) -> dict:
    """{kernel: module} of every file ``portbench/work/<kernel>.py`` under
    ``root``."""
    mods = {}
    for path in sorted((root / "portbench" / "work").glob("*.py")):
        if path.stem.startswith("_"):
            continue
        spec = importlib.util.spec_from_file_location(
            f"portbench.work.{path.stem}", path)
        mods[path.stem] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[path.stem])
    return mods


@contextlib.contextmanager
def recording_calls(modules: dict):
    """Record (image shape, other args, kwargs) of every call of each work
    module's wrapper in ``repro_torch.kernels.ops`` while inside; the
    wrappers are put back on exit."""
    from repro_torch.kernels import ops
    calls = {name: [] for name in modules}
    saved = {}

    def wrap(name, fn):
        def recorded(img, *args, **kwargs):
            calls[name].append((tuple(img.shape), args, kwargs))
            return fn(img, *args, **kwargs)
        return recorded

    for name, mod in modules.items():
        fn = getattr(ops, mod.WRAPPER, None)
        if fn is not None:
            saved[mod.WRAPPER] = fn
            setattr(ops, mod.WRAPPER, wrap(name, fn))
    try:
        yield calls
    finally:
        for attr, fn in saved.items():
            setattr(ops, attr, fn)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Activity(NamedTuple):
    """A kernel, copy or memset on a card: its name, start and end (us,
    clipped to the window), the card's index, its stream, and the
    profiler's correlation id, which its launching runtime call shares."""
    name: str
    start: float
    end: float
    card: int = 0
    stream: int = 0
    id: int = 0


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


class Trace:
    """One profiled window: ``window`` its (start, end) in us,
    ``activities`` its device `Activity` list over every card, ``kernels``
    and ``copies`` the same as [(name, start us, end us)], ``host`` the
    host events [(name, start, end)] that start inside it and ``host_ids``
    their correlation ids (0 where none), ``cards`` the indices of the
    cards the run used, ``scenes`` the scenes it holds, ``calls`` the
    wrapper calls by kernel, ``modules`` the work modules by kernel.

    Busy and idle time are read card by card (`busy`, `gaps`); the trace's
    `busy_s` is the mean over the cards."""

    def __init__(self, window, host, activities, scenes: int,
                 calls: dict = None, modules: dict = None, cards=None,
                 host_ids=None):
        self.window = tuple(window)
        self.host = [tuple(h) for h in host]
        self.host_ids = list(host_ids or [0] * len(self.host))
        self.activities = [Activity(*a) for a in activities]
        self.kernels = [(a.name, a.start, a.end) for a in self.activities
                        if not _is_copy(a.name)]
        self.copies = [(a.name, a.start, a.end) for a in self.activities
                       if _is_copy(a.name)]
        self.cards = sorted(set(cards) if cards is not None else
                            {a.card for a in self.activities} or {0})
        self.scenes = scenes
        self.calls = calls or {}
        self.modules = modules or {}

    @classmethod
    def from_profiler(cls, prof, scenes: int, calls: dict, modules: dict,
                      cards=None):
        """The window of ``prof`` (the host span ``portbench.window``):
        device activities clipped to it, host events that start in it."""
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        events = list(prof.events())
        window = [e for e in events if e.name == WINDOW]
        if not window:
            raise RuntimeError("the profiler recorded no window span")
        lo, hi = window[0].time_range.start, window[0].time_range.end
        host, host_ids, activities = [], [], []
        # a host span's range on the device timeline comes back as a device
        # event of the same name: it is no device activity
        host_names = {e.name for e in events if e.device_type != cuda}
        for e in events:
            s, t = e.time_range.start, e.time_range.end
            if e.device_type == cuda:
                if e.name in host_names:
                    continue
                s, t = max(s, lo), min(t, hi)
                if t <= s:
                    continue
                activities.append(Activity(e.name, s, t, e.device_index,
                                           e.device_resource_id or 0, e.id))
            elif e.name not in (WINDOW, SCENE) and lo <= s < hi:
                host.append((e.name, s, t))
                host_ids.append(e.id)
        return cls((lo, hi), host, activities, scenes, calls, modules,
                   cards, host_ids)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy(self, card=None):
        """Merged [start, end] intervals in which any device activity ran
        on ``card`` (on any card where None)."""
        return _merge([(a.start, a.end) for a in self.activities
                       if card is None or a.card == card])

    def card_busy_s(self) -> dict:
        """{card: seconds in which an activity ran on it}."""
        return {c: sum(t - s for s, t in self.busy(c)) * 1e-6
                for c in self.cards}

    @property
    def busy_s(self) -> float:
        """Busy seconds, the mean over the cards."""
        per_card = self.card_busy_s()
        return sum(per_card.values()) / len(per_card)

    def gaps(self, card):
        """[(start, end)] of the window in which nothing ran on ``card``."""
        out, prev = [], self.window[0]
        for s, t in self.busy(card) + [[self.window[1], self.window[1]]]:
            if s > prev:
                out.append((prev, s))
            prev = max(prev, t)
        return out

    def kernel_seconds(self, names) -> float:
        """Device seconds of the kernels whose names hold any of ``names``."""
        return sum(t - s for n, s, t in self.kernels
                   if any(p in n for p in names)) * 1e-6

    def hand_kernel_names(self):
        return tuple(p for m in self.modules.values() for p in m.DEVICE_NAMES)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (over every card), and
        the longest idle gaps of the cards, each named by the innermost
        host operation running at its middle ("python" where none ran) and,
        on more than one card, prefixed by its card (``cuda:<i> ``)."""
        by_op = {}
        for n, s, t in self.kernels + self.copies:
            by_op[n[:120]] = by_op.get(n[:120], 0.0) + (t - s) * 1e-6
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(((s, t, c) for c in self.cards
                       for s, t in self.gaps(c)),
                      key=lambda g: g[0] - g[1])[:top]
        named = []
        for s, t, c in gaps:
            mid = (s + t) / 2
            inner = [h for h in self.host if h[1] <= mid < h[2]]
            name = (min(inner, key=lambda h: h[2] - h[1])[0][:120] if inner
                    else "python")
            if len(self.cards) > 1:
                name = f"cuda:{c} {name}"
            named.append([name, (t - s) * 1e-6])
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}
