"""Decode attention's share of its roofline in the traced interval: the
bound (K and V of each decode token's context read once, ``work.py``) of
every decode token that reached its client in the interval, over the
device time of ``decode_kernel`` and ``decode_combine_kernel``. Tokens are
placed in the interval by their arrival at the client, which trails the
step by one readback: an approximation until a span marks the steps."""

from portbench import work
from portbench.window import decode_keys, kernel_seconds, share

KERNELS = r"(^|::)(decode_kernel|decode_combine_kernel)$"


def read(record):
    trace = record["trace"]
    if not trace:
        return None
    s, peaks = record["shapes"], record["peaks"]
    bound = sum(work.decode_attention_bound_s(s, k, peaks) for k in decode_keys(record, trace["t0"], trace["t1"]))
    return share(bound, kernel_seconds(record, KERNELS))
