"""The decode-attention kernels' share of their roofline, read by the
``decode_attention_roofline.*`` metrics.

Bound, for every row of every decode step in the traced sub-window
(``ctx.decodes``, each row's attended positions) and every attention
layer: the larger of its bytes (the row's live K and V, each read once,
and its q and output, in bf16) at 3.35 TB/s and its ``4 h d ctx``
operations at 989 TFLOP/s. Time: the device time of the kernels named
``*decode_attn*`` (a partial and a merge kernel per layer and step).
"""
from __future__ import annotations

import sys
from typing import Dict

from perfbench import peaks

BF16 = 2
#: the part of both kernels' names that the trace is searched for
KERNEL = "decode_attn"
#: kernels launched per attention layer and decode step
PER_LAYER = 2


def row_bound_s(m: Dict, ctx: int) -> float:
    """One row attending ``ctx`` positions in one attention layer."""
    h, hkv, d = m["n_heads"], m["kv_heads"], m["head_dim"]
    nbytes = BF16 * (2 * ctx * hkv * d + 2 * h * d)
    return peaks.bound_s(4.0 * h * d * ctx, nbytes)


def roofline(ctx, n_attn: int):
    """The bound over the kernels' device time, in %. None, with a line on
    standard error, where the trace holds no decode step, or where its
    decode_attn kernels are not ``PER_LAYER`` per attention layer and
    step, within one step's worth at the sub-window's edges."""
    tr = ctx.trace
    if tr is None or not ctx.decodes:
        return None
    n, secs = tr.kernels(KERNEL)
    per_step = PER_LAYER * n_attn
    want = per_step * len(ctx.decodes)
    if abs(n - want) > per_step or secs <= 0:
        print(f"perfbench: decode_attention_roofline: {n} {KERNEL} kernels "
              f"in the trace, want {want} ({PER_LAYER} x {n_attn} attention "
              f"layers x {len(ctx.decodes)} decode steps)", file=sys.stderr)
        return None
    bound = n_attn * sum(row_bound_s(ctx.model, c)
                         for step in ctx.decodes for c in step)
    return 100.0 * bound / secs
