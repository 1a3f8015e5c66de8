"""Kernels: the SSD scans' bound in the prefills of the traced sub-window
of a hybrid_moe cell (per scan the larger of its operations at 989
TFLOP/s and its bytes at 3.35 TB/s, ``flops_hybrid.ssd_call`` over the
unpadded prompt length) over the device time of the kernels named
``*ssd_intra*`` and ``*ssd_inter*``, in %. None, with a line on standard
error, where the trace does not hold one of each pass for every Mamba2
layer of every prefill."""
import sys

from perfbench import flops_hybrid, peaks


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.prefills:
        return None
    n_mamba = flops_hybrid.kinds(ctx.model).count("mamba")
    want = n_mamba * len(ctx.prefills)
    (n_intra, t_intra), (n_inter, t_inter) = (tr.kernels("ssd_intra"),
                                              tr.kernels("ssd_inter"))
    if n_intra != want or n_inter != want or t_intra + t_inter <= 0:
        print(f"perfbench: ssd_scan_roofline: {n_intra} intra and {n_inter} "
              f"inter kernels in the trace, want {want} of each ({n_mamba} "
              f"Mamba2 layers x {len(ctx.prefills)} prefills)",
              file=sys.stderr)
        return None
    calls = [flops_hybrid.ssd_call(ctx.model, s) for s in ctx.prefills]
    bound = n_mamba * sum(peaks.bound_s(c["flops"], c["bytes"])
                          for c in calls)
    return 100.0 * bound / (t_intra + t_inter)
