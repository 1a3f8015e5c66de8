"""Kernels: the expanded prefill's causal attention against its bound in
the traced sub-window of the long-chat cell, in %. Bound, for every
prefill and each layer: the causal operations at q.k nope + rope and v
v_dim over the unpadded prompt at 989 TFLOP/s, or its bytes at 3.35 TB/s
if more (``flops_mla.flash_call``). Time: the device events named
``*flash_fwd*`` (the padded bucket's flash, one per layer). None, with a
line on standard error, unless the trace holds one per layer of every
prefill."""
import sys

from perfbench import flops_mla, peaks

KERNEL = "flash_fwd"


def read(ctx):
    tr = ctx.trace
    if tr is None or not ctx.prefills:
        return None
    layers = ctx.model["n_layers"]
    n, secs = tr.kernels(KERNEL)
    want = layers * len(ctx.prefills)
    if n != want or secs <= 0:
        print(f"perfbench: mla_prefill_attention_roofline: {n} {KERNEL} "
              f"kernels in the trace, want {want} ({layers} layers x "
              f"{len(ctx.prefills)} prefills)", file=sys.stderr)
        return None
    bound = 0.0
    for s in ctx.prefills:
        call = flops_mla.flash_call(ctx.model, s)
        bound += layers * peaks.bound_s(call["flops"], call["bytes"])
    return 100.0 * bound / secs
