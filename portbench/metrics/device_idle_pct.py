"""Share of the traced window in which no kernel, copy or fill ran on the card."""
from portbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
