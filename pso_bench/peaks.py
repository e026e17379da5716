"""Published peaks of one NVIDIA H100 SXM (NVIDIA's H100 data sheet, dense
rates, at the 700 W power limit), the rates a kernel's roofline share is
taken against. Each is a rate that no choice of instructions beats."""

#: HBM3 bandwidth, bytes a second.
HBM_BYTES_PER_S = 3.35e12

#: float32 outside the tensor cores: 67 TFLOP/s, an FMA counted as two
#: operations (128 float32 lanes an SM, 132 SMs, two operations a lane a
#: clock).
FP32_OPS_PER_S = 67e12

#: 32-bit integer: 64 integer lanes an SM, half the float32 lanes (CUDA C++
#: Programming Guide, arithmetic instruction throughput for compute
#: capability 9.0), an IMAD counted as two operations, as the FMA is.
INT32_OPS_PER_S = FP32_OPS_PER_S / 2


def bound_ms(cost: dict) -> float:
    """The least time in ms for a launch of ``cost`` (``bytes``,
    ``int_ops``, ``fp_ops``): the largest of its bytes at the HBM rate and
    its operations at the integer and float32 rates."""
    return 1e3 * max(cost["bytes"] / HBM_BYTES_PER_S,
                     cost["int_ops"] / INT32_OPS_PER_S,
                     cost["fp_ops"] / FP32_OPS_PER_S)
