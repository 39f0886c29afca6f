"""Device idle milliseconds a scene in the gaps whose middle falls, on the
host, inside a ``difet.*`` span of the program: the idle that the engine's
own host work causes (synchronizations, pageable copies, Python between
launches), as against the harness's loop.  The gaps are those of
`Trace.gaps`, card by card; on more than one card the reading is the mean
over the cards."""
from portbench.metrics.span import innermost, program_spans


def read(trace):
    spans = program_spans(trace)
    if not spans or not (trace.kernels or trace.copies):
        return None
    total = 0.0
    for card in trace.cards:
        gaps = trace.gaps(card)
        inside = innermost(spans, [(s + t) / 2 for s, t in gaps])
        total += sum(t - s for (s, t), name in zip(gaps, inside)
                     if name is not None)
    return total * 1e-3 / len(trace.cards) / trace.scenes
