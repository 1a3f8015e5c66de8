"""Target hardware constants (NVIDIA H100 SXM5) for converting counted
FLOPs and bytes to seconds.

The port's counterpart of ``src/repro/roofline/hw.py`` (lines 1-28): the
same ``HardwareSpec`` with its link fields named for NVLink, and the
H100 in place of the reference's target. Each constant cites its
source: NVIDIA's H100 Tensor Core GPU data sheet, SXM5 column, and
NVIDIA's H100 Tensor Core GPU Architecture whitepaper for what the data
sheet does not list (the NVLink link count, the shared memory per SM).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops_bf16: float        # FLOP/s per chip, dense
    hbm_bandwidth: float          # bytes/s per chip
    nvlink_link_bandwidth: float  # bytes/s per link direction
    nvlink_links_per_chip: int
    hbm_bytes: float              # capacity per chip
    smem_bytes_per_sm: float      # on-chip scratch per SM


H100_SXM = HardwareSpec(
    name="h100-sxm",
    # data sheet: BF16 Tensor Core 1,979 TFLOPS with sparsity, 989 dense
    peak_flops_bf16=989e12,
    # data sheet: GPU memory bandwidth 3.35 TB/s (HBM3)
    hbm_bandwidth=3.35e12,
    # data sheet: NVLink 900 GB/s (bidirectional); the architecture
    # whitepaper: over 18 fourth-generation links, so 50 GB/s per link and
    # 25 GB/s in each direction
    nvlink_link_bandwidth=25e9,
    nvlink_links_per_chip=18,
    # data sheet: GPU memory 80 GB
    hbm_bytes=80e9,
    # the architecture whitepaper: up to 228 KB of shared memory per SM
    smem_bytes_per_sm=228 * 1024,
)
