"""Hand-written Hopper kernels of the port, one package per TPU kernel.

  flash_attention/  causal GQA flash attention, CUDA C++ for sm_90a
                    (replaces repro/kernels/flash_attention)
  rmsnorm/          fused residual-add + RMSNorm, Triton
                    (replaces repro/kernels/rmsnorm)
  ssd_scan/         the Mamba2 SSD scan's intra- and inter-chunk passes,
                    CUDA C++ for sm_90a (replaces repro/kernels/ssd_scan)

Each package keeps the reference's split: ``kernel.py`` (the launch),
``ref.py`` (plain torch) and ``ops.py`` (dispatch). ``ops`` takes the
plain version only for a tensor on the CPU; for a CUDA tensor it
launches the kernel or raises. Each ``ops`` module counts its kernels'
launches (``launches``; ``intra_launches`` and ``inter_launches`` for
the SSD scan). Nothing is built or imported from Triton
until a kernel is first launched.
"""
