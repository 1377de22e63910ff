"""The int8 weight products' share of their roofline in the traced
interval. Every int8 product of the model runs one kernel,
``w8a16_grouped_kernel`` (the expert stacks with the expert in the grid,
q/k/v/o and the head at one expert), so its device time is set against the
bound of all of them (``work.w8a16_bound_s``): each decode step's forward
of its live lanes (steps and live lanes from the engine's counters around
the trace and the tokens that reached their clients in it) and each turn's
prefill as one forward of its new tokens, weights read once a forward."""

from portbench import work
from portbench.window import decode_keys, decode_token_steps, kernel_seconds, prefills, share

KERNELS = r"(^|::)w8a16_grouped_kernel$"


def read(record):
    trace = record["trace"]
    s, peaks = record["shapes"], record["peaks"]
    if not trace or s.quant != "int8":
        return None
    steps = decode_token_steps(trace["counters"])
    tokens = len(decode_keys(record, trace["t0"], trace["t1"]))
    bound = 0.0
    if steps > 0 and tokens > 0:
        lanes = max(1, round(tokens / steps))
        bound += steps * work.w8a16_bound_s(s, lanes, peaks, logits_rows=lanes)
    for a, b in prefills(record, trace["t0"], trace["t1"]):
        bound += work.w8a16_bound_s(s, b - a, peaks, logits_rows=1)
    return share(bound, kernel_seconds(record, KERNELS))
