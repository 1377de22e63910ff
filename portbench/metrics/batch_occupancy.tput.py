"""Live lanes per decode chunk over the window (``window.live_lanes``), in a
cell that judges ``output_tokens_per_s``."""

from portbench.window import live_lanes


def read(record):
    return live_lanes(record)
