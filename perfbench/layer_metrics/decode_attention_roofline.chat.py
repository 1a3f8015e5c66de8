"""Kernels: the decode-attention kernels' bound over their device time in
the decode steps of the traced sub-window, in % (``decode_attn.py``); every
layer of the decoder attends."""
from perfbench import decode_attn


def read(ctx):
    return decode_attn.roofline(ctx, ctx.model["n_layers"])
