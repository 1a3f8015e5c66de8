"""Arithmetic shared by the per-layer readers (``layer_metrics/*.py``).

A reader gets ``ctx``: the cell, the configuration's ``model`` sizes,
the engine's counter deltas over the window outside the traced
sub-window (``ctx.engine``), the reduced trace of the sub-window
(``ctx.trace``), the prompt length of every prefill in it
(``ctx.prefills``), the attended positions of every row of every decode
step in it (``ctx.decodes``), and the kernels' launch-counter deltas
over it (``ctx.launches``). A reader that finds nothing to read returns
None, and the metric is left out of the line.
"""
from __future__ import annotations

import sys

from perfbench import flops, peaks


def per_call_ms(total_s: float, n: int):
    return total_s / n * 1e3 if n else None


def mfu(ctx):
    """Model FLOPs of every prefill and decode step in the sub-window over
    its wall time at the bf16 peak, in %."""
    tr = ctx.trace
    if tr is None or not (ctx.prefills or ctx.decodes):
        return None
    work = sum(flops.prefill_flops(ctx.model, s) for s in ctx.prefills)
    work += sum(flops.decode_flops(ctx.model, c) for c in ctx.decodes)
    return 100.0 * work / (tr.window_s * peaks.PEAK_FLOPS_BF16)


def idle_share(ctx):
    tr = ctx.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def roofline(ctx, passes):
    """The bound of the calls over the device time of their kernels, in %.
    ``passes``: (a part of the kernel's name, launch counter, the calls'
    (flops, bytes) list) for each kernel the work runs in. None where no call
    ran, or where the trace's kernels do not match the launch counter."""
    bound = busy = 0.0
    for pattern, counter, calls in passes:
        if not calls:
            return None
        n, secs = ctx.trace.kernels(pattern)
        if n != ctx.launches[counter] or n != len(calls) or secs <= 0:
            print(f"perfbench: {pattern}: {n} kernels in the trace, "
                  f"{ctx.launches[counter]} launches counted, "
                  f"{len(calls)} calls", file=sys.stderr)
            return None
        bound += sum(peaks.bound_s(c["flops"], c["bytes"]) for c in calls)
        busy += secs
    return 100.0 * bound / busy


def flash_calls(ctx):
    return [flops.flash_call(*c) for s in ctx.prefills
            for c in flops.flash_calls_of_prefill(ctx.model, s)]

