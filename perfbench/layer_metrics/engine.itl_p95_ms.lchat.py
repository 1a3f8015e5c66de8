"""Engine: the 95th percentile of the gaps between consecutive tokens of
the long-chat cell, over the window but for the traced sub-window. Its
closed loop keeps every slot full, so it runs at capacity, where a tail
swings with the smallest change: it is judged by its other end-to-end
metrics."""
from perfbench.e2e import percentile


def read(ctx):
    return percentile(ctx.itl_untraced_ms, 95) if ctx.itl_untraced_ms \
        else None
