"""Engine: the 95th percentile of the gaps between consecutive tokens,
over the window but for the traced sub-window, in the cells whose ITL
tail swings too far between runs to hold a bound: the closed loop keeps
every slot full, so it runs at capacity, where a tail swings with the
smallest change. Those cells are judged by their other end-to-end
metrics."""
from perfbench.e2e import percentile


def read(ctx):
    return percentile(ctx.itl_untraced_ms, 95) if ctx.itl_untraced_ms \
        else None
