"""Accelerator envelope: peak FLOP/s and memory bandwidth per device kind.

Reference: ``agentainer_tpu/utils/hw.py``, which lists TPU kinds only. The
engine's MFU/MBU metrics divide its achieved rates by these peaks. Numbers
are published data-sheet peaks per device (dense, no sparsity).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ChipSpec:
    kind: str
    bf16_flops: float  # peak FLOP/s, bf16 into f32, dense
    hbm_gbps: float  # bytes/s


# substring match against torch.cuda.get_device_name(), lowercased; first hit
# wins. H100 SXM from NVIDIA's data sheet: 989 TFLOP/s bf16 dense, HBM3 at
# 3.35 TB/s (at the 700 W power limit).
_SPECS: tuple[ChipSpec, ...] = (
    ChipSpec("h100", 989e12, 3.35e12),
)

# CPU runs keep the MFU arithmetic runnable; the number is meaningless and
# flagged by ``kind`` so callers can label it.
_CPU = ChipSpec("cpu-fallback", 1e12, 50e9)


def chip_spec(device=None) -> ChipSpec:
    """Spec for a torch device (default: CUDA device 0 when present)."""
    import torch

    dev = torch.device(device) if device is not None else None
    if dev is None and torch.cuda.is_available():
        dev = torch.device("cuda", 0)
    if dev is None or dev.type != "cuda":
        return _CPU
    name = torch.cuda.get_device_name(dev).lower()
    for s in _SPECS:
        if s.kind in name:
            return s
    # an unlisted card: placeholder peaks, labelled so no MFU reads as real
    return ChipSpec(f"unlisted: {name}", _CPU.bf16_flops, _CPU.hbm_gbps)
