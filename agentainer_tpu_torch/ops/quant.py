"""Weight-only int8 tensors. Reference: ``agentainer_tpu/ops/quant.py``.

``QTensor(q, scale)`` keeps symmetric per-output-channel scales reduced over
the contraction axis (-2). This slice serves dense weights only: ``dequant``
passes dense tensors through and ``embed_lookup`` gathers dense rows. The
int8 branches are carried so the model code keeps one shape; int8 serving
(and a fused int8 GEMM to keep its bandwidth saving) is later work.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QTensor(NamedTuple):
    """int8 weights; ``dequant = q * scale`` (scale keeps dims, size 1 on
    the contraction axis)."""

    q: torch.Tensor
    scale: torch.Tensor


def dequant(x) -> torch.Tensor:
    """QTensor → dense; dense tensors pass through unchanged."""
    if isinstance(x, QTensor):
        return x.q.to(x.scale.dtype) * x.scale
    return x


def embed_lookup(embed, tokens: torch.Tensor) -> torch.Tensor:
    """Row gather that never materializes a dense vocab table: gather the
    int8 rows first, then scale — [B, T, D] work instead of [V, D]."""
    if isinstance(embed, QTensor):
        return embed.q[tokens].to(embed.scale.dtype) * embed.scale
    return embed[tokens]
