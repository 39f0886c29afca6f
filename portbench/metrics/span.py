"""``<stage>_span``: device milliseconds a scene of the kernels, copies and
memsets launched while a ``difet.<stage>.*`` span of the program was the
innermost of its ``difet.*`` spans (`repro_torch/core/engine.py`:
``response``, ``select``, ``describe``, ``reduce``).

A device activity is tied to its launch exactly, never by overlapping host
and device times: a cell runs on one stream, so the n-th launching runtime
call on the host (``cudaLaunchKernel*``, ``cudaMemcpy*``, ``cudaMemset*``
and their driver-API forms) is the n-th kernel, copy or memset on the
device.  Where the two counts differ the pairing does not hold and the
reader returns None, as it does on a trace with no program span."""

PREFIX = "difet."
LAUNCHES = ("cudaLaunchKernel", "cudaMemcpy", "cudaMemset",
            "cuLaunchKernel", "cuMemcpy", "cuMemset")


def program_spans(trace):
    """The program's ``difet.*`` host ranges [(name, start, end)], in the
    order they opened (an enclosing range before the ranges it holds)."""
    return sorted((h for h in trace.host if h[0].startswith(PREFIX)),
                  key=lambda h: (h[1], -h[2]))


def innermost(spans, times):
    """For each of the ascending ``times``, the name of the innermost of
    ``spans`` open at it, or None.  The program's spans nest (each closes
    on the thread that opened it, before its parent), so the innermost is
    the latest opened that has not closed."""
    out, stack, j = [], [], 0
    for t in times:
        while j < len(spans) and spans[j][1] <= t:
            while stack and stack[-1][2] <= spans[j][1]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][2] <= t:
            stack.pop()
        out.append(stack[-1][0] if stack else None)
    return out


def attribute(trace):
    """{innermost program span at the launch, or None: device seconds} over
    every device activity of the window; None where the trace holds no
    program span or no device activity, or the launches and activities do
    not pair one to one."""
    spans = program_spans(trace)
    launches = sorted(s for n, s, _ in trace.host if n.startswith(LAUNCHES))
    device = sorted(trace.kernels + trace.copies, key=lambda a: a[1])
    if not spans or not device or len(launches) != len(device):
        return None
    out = {}
    for name, (_, s, t) in zip(innermost(spans, launches), device):
        out[name] = out.get(name, 0.0) + (t - s) * 1e-6
    return out


def read(trace, stage):
    prefix = f"{PREFIX}{stage}."
    seconds = attribute(trace)
    if seconds is None or not any(n.startswith(prefix)
                                  for n, _, _ in program_spans(trace)):
        return None
    return 1e3 * sum(v for n, v in seconds.items()
                     if n is not None and n.startswith(prefix)) / trace.scenes
