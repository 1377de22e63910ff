"""Prefill attention's share of its roofline in the traced interval: the
bound (each turn's new prompt positions over their causal context, that
context's K and V read once, ``work.py``) of every turn whose first token
reached its client in the interval, over the device time of
``prefill_kernel``. A turn is placed in the interval by its first token:
an approximation until a span marks the prefill chunks."""

from portbench import work
from portbench.window import kernel_seconds, prefills, share

KERNELS = r"(^|::)prefill_kernel$"


def read(record):
    trace = record["trace"]
    if not trace:
        return None
    s, peaks = record["shapes"], record["peaks"]
    bound = sum(work.prefill_attention_bound_s(s, a, b, peaks) for a, b in prefills(record, trace["t0"], trace["t1"]))
    return share(bound, kernel_seconds(record, KERNELS))
