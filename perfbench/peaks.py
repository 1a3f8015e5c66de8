"""Published peaks of one NVIDIA H100 SXM5 (NVIDIA's H100 Tensor Core GPU
data sheet, SXM5 column, dense rates without sparsity). They assume the
full 700 W power limit; each run prints the card's own limit beside its
numbers."""

#: bf16 / fp16 tensor-core FLOP/s, dense (1,979 with sparsity)
PEAK_FLOPS_BF16 = 989e12
#: HBM3 bytes/s
HBM_BYTES_PER_S = 3.35e12
#: device memory, bytes
HBM_BYTES = 80e9


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the compute and
    the memory term."""
    return max(flops / PEAK_FLOPS_BF16, nbytes / HBM_BYTES_PER_S)
