"""Client-side time to first token, p85 over the requests sent in the
window, as the end-to-end ``ttft_p85_ms`` reads it; a per-layer metric in
the batch cells, where a request's first token waits on whichever decode
chunk it lands behind."""

from portbench.window import percentile, ttft_ms


def read(record):
    values = [ttft_ms(r) for r in record["requests"] if r["in_window"]]
    if any(v is None for v in values):
        return None
    return percentile(values, 85)
