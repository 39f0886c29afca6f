"""What the per-layer metrics read: a ``torch.profiler`` window over a few
scenes, reduced to device activities, host spans and the calls of the
program's hand-kernel wrappers.

The window is the host span ``portbench.window`` around the traced scenes;
device activities (kernels, copies, memsets) are clipped to it.  The
profiler's device timestamps are on the host's clock, so busy and idle
time are read against the same interval.
"""
from __future__ import annotations

import contextlib
import importlib.util
from pathlib import Path

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


class Trace:
    """One profiled window: ``kernels`` and ``copies`` are [(name, start
    us, end us)] clipped to the window, ``window`` its (start, end) in us,
    ``scenes`` the scenes it holds, ``calls`` the wrapper calls by
    kernel, ``modules`` the work modules by kernel."""

    def __init__(self, prof, scenes: int, calls: dict, modules: dict):
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        events = list(prof.events())
        window = [e for e in events if e.name == WINDOW]
        if not window:
            raise RuntimeError("the profiler recorded no window span")
        self.window = (window[0].time_range.start, window[0].time_range.end)
        lo, hi = self.window
        self.kernels, self.copies, self.host = [], [], []
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
                kind = (self.copies if e.name.startswith(("Memcpy", "Memset"))
                        else self.kernels)
                kind.append((e.name, s, t))
            elif e.name not in (WINDOW, SCENE) and lo <= s < hi:
                self.host.append((e.name, s, t))
        self.scenes = scenes
        self.calls = calls
        self.modules = modules

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy(self):
        """Merged [start, end] intervals in which any device activity ran."""
        return _merge([(s, t) for _, s, t in self.kernels + self.copies])

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy()) * 1e-6

    def kernel_seconds(self, names) -> float:
        """Device seconds of the kernels whose names hold any of ``names``."""
        return sum(t - s for n, s, t in self.kernels
                   if any(p in n for p in names)) * 1e-6

    def hand_kernel_names(self):
        return tuple(p for m in self.modules.values() for p in m.DEVICE_NAMES)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by the innermost host operation running at their middle
        ("python" where none ran)."""
        by_op = {}
        for n, s, t in self.kernels + self.copies:
            by_op[n[:120]] = by_op.get(n[:120], 0.0) + (t - s) * 1e-6
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        gaps, prev = [], self.window[0]
        for s, t in self.busy() + [[self.window[1], self.window[1]]]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, t)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        named = []
        for s, t in gaps:
            mid = (s + t) / 2
            inner = [h for h in self.host if h[1] <= mid < h[2]]
            name = (min(inner, key=lambda h: h[2] - h[1])[0][:120] if inner
                    else "python")
            named.append([name, (t - s) * 1e-6])
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}
