"""``<kernel>_roofline``: the least time of the kernel's work in
the window (``portbench/work/<kernel>.py``, summed over its wrapper's
calls, each at the larger of its operations at the fp32 peak and its bytes
at the memory bandwidth) over the kernel's device time in the window."""
from portbench.peaks import least_seconds


def read(trace, kernel):
    mod = trace.modules.get(kernel)
    calls = trace.calls.get(kernel)
    if mod is None or not calls:
        return None
    device_s = trace.kernel_seconds(mod.DEVICE_NAMES)
    if device_s <= 0:
        return None
    bound_s = sum(least_seconds(*mod.work(shape, *args, **kwargs))
                  for shape, args, kwargs in calls)
    return 100.0 * bound_s / device_s
