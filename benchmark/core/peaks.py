"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit): the yardstick of every roofline and ``mfu``."""

BF16_FLOPS = 989e12  # bf16 / fp16 on the tensor cores
TF32_FLOPS = 495e12  # TF32 on the tensor cores
HBM_BYTES = 3.35e12  # bytes a second


def least_s(flops: float, nbytes: float, peak: float = BF16_FLOPS) -> float:
    """The least time the chip needs for work of ``flops`` operations that
    reads and writes ``nbytes``: the larger of the two bounds."""
    return max(flops / peak, nbytes / HBM_BYTES)
