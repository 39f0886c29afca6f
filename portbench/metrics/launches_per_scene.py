"""Device kernels launched per scene, from the profiler: the map over the
tiles and the reduce, torch's own kernels and the hand kernels alike."""


def read(trace):
    if not trace.kernels:
        return None
    return len(trace.kernels) / trace.scenes
