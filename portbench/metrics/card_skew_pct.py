"""How unevenly a mesh's cards were busy over the traced window: 100 x
(the busiest card's busy seconds - the least busy card's) / the busiest
card's.  The slowest card sets a scene's time, so the skew is time the
others wait.  None on one card."""


def read(trace):
    busy = list(trace.card_busy_s().values())
    if len(busy) < 2 or max(busy) <= 0:
        return None
    return 100.0 * (max(busy) - min(busy)) / max(busy)
