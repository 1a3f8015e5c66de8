"""Model step: model FLOPs of the prefills and decode steps in the traced
sub-window of the long-chat cell over its wall time at 989 TFLOP/s, in %
(``flops_mla.py``: expanded attention in a prefill, absorbed in a decode
step, the leading dense layer and the experts' top-k)."""
from perfbench import flops_mla, peaks


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0 or not (ctx.prefills or ctx.decodes):
        return None
    work = sum(flops_mla.prefill_flops(ctx.model, s) for s in ctx.prefills)
    work += sum(flops_mla.decode_flops(ctx.model, c) for c in ctx.decodes)
    return 100.0 * work / (tr.window_s * peaks.PEAK_FLOPS_BF16)
