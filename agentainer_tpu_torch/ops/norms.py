"""Normalization ops. Reference: ``agentainer_tpu/ops/norms.py``.

RMSNorm computed in float32 whatever the input dtype, cast back on return —
the same rounding point as the reference, so bf16 activations round
identically.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    rms = torch.sqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return ((xf / rms) * weight.float()).to(x.dtype)
