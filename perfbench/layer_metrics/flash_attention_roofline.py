"""Kernels: causal flash attention's bound (the larger of its operations
at 989 TFLOP/s and its bytes at 3.35 TB/s, summed over the prefills'
calls in the traced sub-window) over the device time of its kernels
(named ``*flash_fwd*``), in %."""
from perfbench.readers import flash_calls, roofline


def read(ctx):
    return roofline(ctx, [("flash_fwd", "flash", flash_calls(ctx))])
