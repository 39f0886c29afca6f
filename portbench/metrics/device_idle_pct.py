"""Share of the traced window in which no kernel, copy or memset ran on
the card."""


def read(trace):
    if trace.window_s <= 0 or not (trace.kernels or trace.copies):
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
