"""Kernels: the MLA decode kernels' bound over their device time in the
decode steps of the traced sub-window of the long-chat cell, in %. Bound,
for every row of every decode step and each layer: its live latent rows
(kv_rank + rope bf16 each, read once), its query and its output at 3.35
TB/s, or its operations at 989 TFLOP/s if more (``flops_mla.
mla_decode_call``). Time: the device events named ``*mla_decode*`` (a
partial and a merge kernel per layer and step). None, with a line on
standard error, unless the trace holds that count, within one step's
worth at the sub-window's edges: a program without the kernels reads
None."""
import sys

from perfbench import flops_mla, peaks

KERNEL = "mla_decode"
#: kernels launched per layer and decode step
PER_LAYER = 2


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.decodes:
        return None
    layers = ctx.model["n_layers"]
    n, secs = tr.kernels(KERNEL)
    per_step = PER_LAYER * layers
    want = per_step * len(ctx.decodes)
    if abs(n - want) > per_step or secs <= 0:
        print(f"perfbench: mla_decode_roofline: {n} {KERNEL} kernels in the "
              f"trace, want {want} ({PER_LAYER} x {layers} layers x "
              f"{len(ctx.decodes)} decode steps)", file=sys.stderr)
        return None
    bound = 0.0
    for step in ctx.decodes:
        for c in step:
            call = flops_mla.mla_decode_call(ctx.model, c)
            bound += layers * peaks.bound_s(call["flops"], call["bytes"])
    return 100.0 * bound / secs
