"""The whole model's share of the card's bf16 peak over the window:
the prefills' work alone (every turn's new prompt tokens and its first logits), counted from the published shapes (``work.py``), over the window's
seconds on the host's clock, against ``peaks.py``'s bf16 rate."""

from portbench.window import needed_flops


def read(record):
    seconds = record["w1"] - record["w0"]
    flops = needed_flops(record, record["w0"], record["w1"], decode=False)
    if flops <= 0:
        return None
    return 100.0 * flops / seconds / record["peaks"]["bf16_flops"]
