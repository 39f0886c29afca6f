"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W power limit): the yardstick of every roofline share."""
HBM_BYTES_PER_S = 3.35e12      # HBM3
FP32_OPS_PER_S = 67e12         # fp32 outside the tensor cores (FMA = 2)


def least_seconds(ops: float, nbytes: float) -> float:
    """The least time a call can take: the larger of its operations at
    the fp32 peak and its bytes at the memory bandwidth."""
    return max(ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
