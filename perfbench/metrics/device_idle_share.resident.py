"""Share of the traced calls' wall time in which the card ran nothing."""
from perfbench.lib.devtrace import idle_share


def read(ctx):
    return idle_share(getattr(ctx, "trace", None))
