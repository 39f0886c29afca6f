"""Device idle milliseconds a scene in the gaps whose middle falls, on the
host, inside a ``difet.*`` span of the program: the idle that the engine's
own host work causes (synchronizations, pageable copies, Python between
launches), as against the harness's loop.  The gaps are those of
`Trace.breakdown`: between the merged busy intervals of the window."""
from portbench.metrics.span import innermost, program_spans


def read(trace):
    spans = program_spans(trace)
    if not spans or not (trace.kernels or trace.copies):
        return None
    gaps, prev = [], trace.window[0]
    for s, t in trace.busy() + [[trace.window[1], trace.window[1]]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    inside = innermost(spans, [(s + t) / 2 for s, t in gaps])
    return sum(t - s for (s, t), name in zip(gaps, inside)
               if name is not None) * 1e-3 / trace.scenes
