"""Engine: the 95th percentile of the gaps between consecutive tokens of
a hybrid_moe cell, over the window but for the traced sub-window. The
closed loop keeps every slot full, so the cell runs at capacity, where a
tail swings with the smallest change: it is judged by its other
end-to-end metrics."""
from perfbench.e2e import percentile


def read(ctx):
    return percentile(ctx.itl_untraced_ms, 95) if ctx.itl_untraced_ms \
        else None
