"""Weight-only int8 tensors. Reference: ``agentainer_tpu/ops/quant.py``.

``QTensor(q, scale)`` keeps symmetric per-output-channel scales reduced over
the contraction axis (-2): for a matmul weight ``[..., K, N]`` every output
channel n keeps its own scale per leading index (layer), so a stacked
``[L, ...]`` weight slices per field into one layer's ``QTensor``.

The reference leaves ``x @ dequant(w)`` to XLA, which fuses the convert into
the dot. Here every weight product goes through ``qmatmul``: a dense weight
is a plain ``x @ w``; an int8 one runs ``ops/cuda_quant.w8a16_matmul``, the
hand-written fused kernel on the card and its plain version on the CPU, so
no dense weight is written out on the card. An MoE layer's expert stacks
``[E, K, N]`` go through ``qmatmul_experts`` the same way, every expert in
one call (``w8a16_grouped_matmul`` for an int8 stack).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .cuda_quant import w8a16_grouped_matmul, w8a16_matmul


class QTensor(NamedTuple):
    """int8 weights; ``dequant = q * scale`` (scale keeps dims, size 1 on
    the contraction axis)."""

    q: torch.Tensor
    scale: torch.Tensor


def quantize_into(w: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> None:
    """One ``[K, N]`` slice, the reference's arithmetic in f32 bit for bit:
    absmax over K, ``/ 127``, a zero scale made 1, ``q = clip(rint(w /
    scale), -127, 127)``. Every division is tensor by tensor: on the card
    torch divides by a Python scalar through its reciprocal, which can
    differ from numpy's division in the last bit."""
    w32 = w.to(device=q.device, dtype=torch.float32)
    absmax = w32.abs().amax(dim=-2, keepdim=True)
    s = absmax / torch.full_like(absmax, 127.0)
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    q.copy_(torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8))
    scale.copy_(s)


def quantize_array(w, dtype=torch.bfloat16, device=None) -> QTensor:
    """Symmetric int8 with scales over axis -2 (the contraction axis), the
    scale stored in ``dtype``. ``w`` is a tensor or a numpy array; the result
    lives on ``device`` (default: w's), and a stacked ``[L, K, N]`` weight is
    quantized one ``[K, N]`` slice at a time, so the f32 work stays one
    slice big and, given a device tensor, the weight never leaves the
    device."""
    if isinstance(w, np.ndarray):
        w = torch.from_numpy(np.ascontiguousarray(w))
    dev = torch.device(device) if device is not None else w.device
    shape = tuple(w.shape)
    q = torch.empty(shape, dtype=torch.int8, device=dev)
    scale = torch.empty(shape[:-2] + (1,) + shape[-1:], dtype=dtype, device=dev)
    lead = int(np.prod(shape[:-2], dtype=np.int64))
    flat_w = w.reshape(lead, *shape[-2:])
    flat_q, flat_s = q.view(lead, *shape[-2:]), scale.view(lead, 1, shape[-1])
    for i in range(lead):
        quantize_into(flat_w[i], flat_q[i], flat_s[i])
    return QTensor(q=q, scale=scale)


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


def layer_slice(w, layer: int):
    """Layer ``layer`` of a stacked ``[L, ...]`` weight: a view of a dense
    leaf, or a ``QTensor`` of the two fields' views."""
    if isinstance(w, QTensor):
        return QTensor(w.q[layer], w.scale[layer])
    return w[layer]


def qmatmul(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` for a dense weight, ``x @ dequant(w)`` for a ``QTensor``
    through ``w8a16_matmul`` over x's flattened leading dims."""
    if not isinstance(w, QTensor):
        return x @ w
    k = x.shape[-1]
    y = w8a16_matmul(x.reshape(-1, k).contiguous(), w.q, w.scale)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def qmatmul_experts(x: torch.Tensor, w) -> torch.Tensor:
    """Every expert's product at once: ``x [M, K]`` (the same input for
    every expert) or ``[E, M, K]`` (one per expert) against the expert
    stack ``w [E, K, N]`` → ``[E, M, N]``. A dense stack is a batched
    ``x @ w``; a ``QTensor`` one runs ``w8a16_grouped_matmul``, which raises
    on a shape its kernel does not take."""
    if not isinstance(w, QTensor):
        return torch.matmul(x, w)
    return w8a16_grouped_matmul(x.contiguous(), w.q, w.scale)
