"""Share of the traced interval in which no operation ran on the device
(``window.idle_share``), in a cell that judges ``ttft_p85_ms``."""

from portbench.window import idle_share


def read(record):
    return idle_share(record)
