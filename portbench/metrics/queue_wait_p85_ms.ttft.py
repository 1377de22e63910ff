"""The engine's queue wait (submit → first prefill chunk, each result's
``ttft_breakdown.queue_ms``), p85 over the window's requests."""

from portbench.window import percentile


def read(record):
    values = [r["queue_ms"] for r in record["requests"] if r["in_window"] and r["queue_ms"] is not None]
    return percentile(values, 85)
