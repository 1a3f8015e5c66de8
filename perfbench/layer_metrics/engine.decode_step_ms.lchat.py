"""Engine: wall time per decode step of the whole batch of the long-chat
cell, logits read back and tokens chosen, over the window outside the
traced sub-window (``ServeEngine.decode_s / decode_steps``)."""
from perfbench.readers import per_call_ms


def read(ctx):
    return per_call_ms(ctx.engine["decode_s"], ctx.engine["decode_steps"])
