"""Engine: wall time per admission (prefill and slot copy, ending in the
first token's read-back), over the window outside the traced sub-window
(``ServeEngine.prefill_s / n_prefills``)."""
from perfbench.readers import per_call_ms


def read(ctx):
    return per_call_ms(ctx.engine["prefill_s"], ctx.engine["n_prefills"])
