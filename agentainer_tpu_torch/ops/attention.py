"""Attention ops — plain PyTorch reference implementations + CUDA kernel
dispatch.

Reference: ``agentainer_tpu/ops/attention.py`` (the dense half:
``attention_reference``, ``causal_mask``, ``cache_mask``,
``flash_attention``, ``cache_attention``). The paged half waits for the
paged-KV slice.

Dispatch follows the reference's ``_use_pallas``: the hand-written kernels
(ops/cuda_attention.py) run when the tensors live on a CUDA device and
``kernel_supported`` holds for the shape; anything else takes the plain
reference path. Softmax runs in float32; GQA groups query heads over shared
KV heads instead of repeating K/V.
"""

from __future__ import annotations

import torch

from .cuda_attention import flash_attention_causal, flash_decode, flash_prefill, kernel_supported

NEG_INF = -1e30


def _group_query_heads(q: torch.Tensor, n_kv_heads: int) -> torch.Tensor:
    """[B, T, H, hd] → [B, T, KV, G, hd] where H = KV * G."""
    b, t, h, hd = q.shape
    if h % n_kv_heads:
        raise ValueError(f"heads {h} not divisible by kv heads {n_kv_heads}")
    return q.reshape(b, t, n_kv_heads, h // n_kv_heads, hd)


def attention_reference(
    q: torch.Tensor,  # [B, Tq, H, hd]
    k: torch.Tensor,  # [B, Tk, KV, hd]
    v: torch.Tensor,  # [B, Tk, KV, hd]
    mask: torch.Tensor | None = None,  # broadcastable to [B, Tq, Tk]
) -> torch.Tensor:
    """Plain scaled dot-product attention with GQA. Returns [B, Tq, H, hd]."""
    n_kv = k.shape[2]
    qg = _group_query_heads(q, n_kv)  # [B,Tq,KV,G,hd]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if mask is not None:
        scores = torch.where(mask[:, None, None, :, :], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    b, tq, kv, g, hd = out.shape
    return out.reshape(b, tq, kv * g, hd).to(q.dtype)


def causal_mask(t: int, device=None) -> torch.Tensor:
    """[1, T, T] lower-triangular mask."""
    return torch.tril(torch.ones((t, t), dtype=torch.bool, device=device))[None]


def cache_mask(q_positions: torch.Tensor, cache_len: int) -> torch.Tensor:
    """Mask for attending over a KV cache of static size ``cache_len``: a
    query at position p may see cache slot j iff j <= p. [B, Tq] → [B, Tq, S]."""
    slots = torch.arange(cache_len, device=q_positions.device)[None, None, :]
    return slots <= q_positions[:, :, None]


def _use_kernel(x: torch.Tensor, n_heads: int, n_kv_heads: int, head_dim: int) -> bool:
    return x.device.type == "cuda" and kernel_supported(n_heads, n_kv_heads, head_dim)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
    causal: bool = False,
) -> torch.Tensor:
    """Dispatch: the prefill kernel on CUDA for causal no-cache attention,
    the plain reference elsewhere."""
    if causal and mask is None and _use_kernel(q, q.shape[2], k.shape[2], q.shape[3]):
        return flash_attention_causal(q, k, v)
    if causal and mask is None:
        mask = causal_mask(q.shape[1], device=q.device)
    return attention_reference(q, k, v, mask=mask)


def cache_attention(
    q: torch.Tensor,  # [B, T, H, hd]
    ck: torch.Tensor,  # [B, S, KV, hd] arena (slots >= positions are unwritten)
    cv: torch.Tensor,  # [B, S, KV, hd]
    positions: torch.Tensor,  # [B, T] int per-sequence absolute positions
    use_kernel: bool = True,
) -> torch.Tensor:
    """Attention over the KV arena: row t sees slot j iff j <= positions[b,t].

    The serving hot path (ragged cached prefill and T == 1 decode). On CUDA
    with a kernel-shaped head it sends T > 1 to ``flash_prefill`` and
    T == 1 to ``flash_decode``; elsewhere — or with ``use_kernel=False``,
    the reference's ``use_pallas=False`` — it materializes ``cache_mask``
    and runs the plain reference."""
    if use_kernel and _use_kernel(q, q.shape[2], ck.shape[2], q.shape[3]):
        pos = positions.to(torch.int32)
        if q.shape[1] == 1:
            return flash_decode(q[:, 0], ck, cv, pos[:, 0])[:, None]
        return flash_prefill(q, ck, cv, pos)
    return attention_reference(q, ck, cv, mask=cache_mask(positions, ck.shape[1]))
