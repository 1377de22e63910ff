"""Live lanes per decode chunk over the window (``window.live_lanes``), in a
cell that judges ``ttft_p85_ms``: in a closed loop a lane waits empty
while its session's next prompt waits for its prefill."""

from portbench.window import live_lanes


def read(record):
    return live_lanes(record)
