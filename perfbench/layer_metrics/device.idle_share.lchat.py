"""Device: share of the traced sub-window of the long-chat cell in which
no operation ran on the card, in %."""
from perfbench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
