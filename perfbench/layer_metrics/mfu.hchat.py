"""Model step: model FLOPs of the prefills and decode steps in the traced
sub-window of a hybrid_moe cell over its wall time at 989 TFLOP/s, in %
(``flops_hybrid.py``: Mamba2 and attention layers each counted as the
configuration's ``layer_types`` lays them out)."""
from perfbench import flops_hybrid, peaks


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or not (ctx.prefills or ctx.decodes):
        return None
    work = sum(flops_hybrid.prefill_flops(ctx.model, s) for s in ctx.prefills)
    work += sum(flops_hybrid.decode_flops(ctx.model, c) for c in ctx.decodes)
    return 100.0 * work / (tr.window_s * peaks.PEAK_FLOPS_BF16)
