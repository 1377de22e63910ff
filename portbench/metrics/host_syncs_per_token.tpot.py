"""Host syncs per generated token over the window: Δhost_syncs_total /
Δtokens_generated (the engine's counters)."""

from portbench.window import counter_delta


def read(record):
    tokens = counter_delta(record["counters"], "tokens_generated")
    if tokens <= 0:
        return None
    return counter_delta(record["counters"], "host_syncs_total") / tokens
