"""Device milliseconds per scene in kernels that are not the program's hand
kernels: the torch ops of the detectors, selection and descriptors
(SURF's integral image and box sums, SIFT's extrema, NMS, ownership, the
stable top-K, the descriptors) and of the reduce."""


def read(trace):
    hand = trace.hand_kernel_names()
    others = [(s, t) for n, s, t in trace.kernels
              if not any(p in n for p in hand)]
    if not others:
        return None
    return sum(t - s for s, t in others) * 1e-3 / trace.scenes
