"""Share of the traced window in which no kernel, copy or memset ran on
the card; on more than one card, the mean over the cards of each card's
share (`Trace.busy_s` is the cards' mean)."""


def read(trace):
    if trace.window_s <= 0 or not (trace.kernels or trace.copies):
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
