"""Share of the prompt tokens sent in the window that the prefix cache
served: Δprefix_tokens_saved over the window / prompt tokens submitted
(a continuing turn's pending output token counted as the engine feeds it)."""

from portbench.window import counter_delta


def read(record):
    submitted = sum(r["ctx0"] - (0 if r["fresh"] else r["need_start"]) for r in record["requests"] if r["in_window"])
    if submitted <= 0:
        return None
    return 100.0 * counter_delta(record["counters"], "prefix_tokens_saved") / submitted
