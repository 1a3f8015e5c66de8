"""Engine: wall time per admission of the long-chat cell (the padded
prefill's replay into the slot, ending in the first token's read-back),
over the window outside the traced sub-window (``ServeEngine.prefill_s /
n_prefills``): admission is about half the wall time there."""
from perfbench.readers import per_call_ms


def read(ctx):
    return per_call_ms(ctx.engine["prefill_s"], ctx.engine["n_prefills"])
