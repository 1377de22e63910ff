"""Rotary position embeddings (RoPE), Llama-3 style.

Reference: ``agentainer_tpu/ops/rope.py``. Split-half rotation
(rotate_half layout), angles and rotation in float32, cast back on return.
"""

from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2], float32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate ``x`` [..., T, n_heads, head_dim] by per-token ``positions`` [..., T].

    Computed in float32 regardless of input dtype (bf16 angles lose precision
    at long context), cast back on return.
    """
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, device=x.device)  # [hd/2]
    angles = positions[..., None].float() * freqs  # [..., T, hd/2]
    cos = torch.cos(angles)[..., None, :]  # [..., T, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)
