"""Share of the traced window in which no kernel ran on the card, in %."""

from cfbench.readers import idle_share

UNIT = "%"


def read(run, summary):
    return idle_share(run, summary, "serve")
