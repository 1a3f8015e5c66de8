"""Kernels: the decode-attention kernels' bound over their device time in
the decode steps of the traced sub-window of a hybrid_moe cell, in %
(``decode_attn.py``), over the attention layers that the configuration's
``layer_types`` lay out."""
from perfbench import decode_attn, flops_hybrid


def read(ctx):
    return decode_attn.roofline(
        ctx, flops_hybrid.kinds(ctx.model).count("attention"))
