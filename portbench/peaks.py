"""Published peaks of the card, the yardstick of every share of a roofline
or of a peak. NVIDIA's H100 SXM data sheet, dense rates without sparsity,
at the 700 W power limit (a card set lower reads its shares against these
all the same; the run records its power limit beside them)."""

from __future__ import annotations

# substring of torch.cuda.get_device_name(), lowercased → peaks
PEAKS = {
    "h100": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks_for(device_name: str) -> dict:
    """The peaks of a card by its name; raises for a card not in the table,
    so no share is read against a guess."""
    low = device_name.lower()
    for key, value in PEAKS.items():
        if key in low:
            return dict(value)
    raise KeyError(f"no published peaks for {device_name!r}")
