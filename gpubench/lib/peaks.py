"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
without sparsity, at the 700 W power limit).  Frozen: every roofline and
utilisation of the benchmark is a share of these."""

BF16_FLOPS = 989e12          # tensor cores, bf16 / fp16
HBM_BYTES_PER_S = 3.35e12    # HBM3


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip can take: the larger of the bf16
    operations over the tensor cores' rate and the bytes over the memory
    rate."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
