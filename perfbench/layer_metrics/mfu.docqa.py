"""Model step: model FLOPs of the prefills and decode steps in the traced
sub-window over its wall time at 989 TFLOP/s, in % (``flops.py``)."""
from perfbench.readers import mfu


def read(ctx):
    return mfu(ctx)
