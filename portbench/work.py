"""The work the traffic needs, counted from the configuration's published
shapes and the tokens the model had to process: never from a kernel's
launch geometry, so it reads the same whatever implements it.

FLOPs are 2 per multiply-add. Bytes count each input read once and each
output written once (bf16 activations and KV, int8 weights with one bf16
scale per output column). A bound is the larger of operations over the
peak rate and bytes over the peak bandwidth (``peaks.py``).

What a turn needs: its new prompt tokens at their context positions (a
session's shared system prompt is not needed again: it was computed once,
in set-up), every output token but the last fed back at its position, and
the logits of every output token."""

from __future__ import annotations

from .shapes import Shapes

BF16 = 2


def layer_matmul_flops(s: Shapes) -> float:
    """Weight products of one token through one layer: q, k, v, o and the
    FFN (an MoE layer: the router and the token's ``experts_per_token``
    experts)."""
    hd = s.head_dim
    attn = s.dim * s.n_heads * hd * 2 + 2 * s.dim * s.n_kv_heads * hd
    ffn = 3 * s.dim * s.ffn_dim
    if s.is_moe:
        ffn = s.experts_per_token * ffn + s.dim * s.n_experts
    return 2.0 * (attn + ffn)


def attention_flops(s: Shapes, keys: int) -> float:
    """q·Kᵀ and p·V of one query over ``keys`` positions, one layer."""
    return 4.0 * s.n_heads * s.head_dim * keys


def lm_head_flops(s: Shapes) -> float:
    return 2.0 * s.dim * s.vocab


def prefill_flops(s: Shapes, start: int, end: int) -> float:
    """Positions ``[start, end)`` fed at once, causal, and the logits of the
    last: every layer's products and attention, then the head."""
    n = end - start
    if n <= 0:
        return 0.0
    keys = n * start + n * (n + 1) // 2  # Σ (p + 1) over the positions
    return s.n_layers * (n * layer_matmul_flops(s) + attention_flops(s, 1) * keys) + lm_head_flops(s)


def decode_flops(s: Shapes, keys: int) -> float:
    """One output token fed back at position ``keys - 1``."""
    return s.n_layers * (layer_matmul_flops(s) + attention_flops(s, keys)) + lm_head_flops(s)


def _bound(flops: float, nbytes: float, peaks: dict) -> float:
    return max(flops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes_per_s"])


def decode_attention_bound_s(s: Shapes, keys: int, peaks: dict) -> float:
    """One decode query over ``keys`` positions, every layer: K and V read
    once, q read and the output written once."""
    hd = s.head_dim
    nbytes = 2 * keys * s.n_kv_heads * hd * BF16 + 2 * s.n_heads * hd * BF16
    return s.n_layers * _bound(attention_flops(s, keys), nbytes, peaks)


def prefill_attention_bound_s(s: Shapes, start: int, end: int, peaks: dict) -> float:
    """Queries at positions ``[start, end)`` over their causal context, every
    layer: the context's K and V read once, q and the output once."""
    n = end - start
    if n <= 0:
        return 0.0
    hd = s.head_dim
    keys = n * start + n * (n + 1) // 2
    nbytes = 2 * end * s.n_kv_heads * hd * BF16 + 2 * n * s.n_heads * hd * BF16
    return s.n_layers * _bound(attention_flops(s, 1) * keys, nbytes, peaks)


def int8_gemm_bound_s(m: int, k: int, n: int, peaks: dict) -> float:
    """``x [m, k] bf16 @ q [k, n] int8`` with bf16 column scales: the
    ``K·N + 2N + 2MK + 2MN`` bytes or the ``2MKN`` operations."""
    return _bound(2.0 * m * k * n, k * n + BF16 * n + BF16 * m * k + BF16 * m * n, peaks)


def experts_touched(s: Shapes, m: int) -> float:
    """Expected distinct experts that ``m`` tokens route to, each choosing
    ``experts_per_token`` of ``n_experts`` (uniform routing)."""
    e, k = s.n_experts, s.experts_per_token
    return e * (1.0 - (1.0 - k / e) ** m)


def expert_gemm_bound_s(s: Shapes, m: int, peaks: dict) -> float:
    """One MoE layer's expert products (gate, up, down) for ``m`` tokens:
    the weights of the experts they touch read once, each token's input to
    its experts and their outputs once; 2 operations a multiply-add of each
    token with each of its experts."""
    if m <= 0:
        return 0.0
    d, f, k = s.dim, s.ffn_dim, s.experts_per_token
    touched = experts_touched(s, m)
    weights = touched * (3 * d * f + BF16 * (2 * f + d))
    acts = BF16 * (m * d + 2 * k * m * f + k * m * f + k * m * d)
    return _bound(2.0 * k * m * 3 * d * f, weights + acts, peaks)


def w8a16_bound_s(s: Shapes, m: int, peaks: dict, logits_rows: int) -> float:
    """Every int8 weight product of ``m`` tokens through the model at once:
    q, k, v and o per layer, the expert products (or a dense FFN's three),
    and the head over ``logits_rows`` rows. The bound of one forward."""
    hd = s.head_dim
    per_layer = (
        int8_gemm_bound_s(m, s.dim, s.n_heads * hd, peaks)
        + 2 * int8_gemm_bound_s(m, s.dim, s.n_kv_heads * hd, peaks)
        + int8_gemm_bound_s(m, s.n_heads * hd, s.dim, peaks)
    )
    if s.is_moe:
        per_layer += expert_gemm_bound_s(s, m, peaks)
    else:
        per_layer += 2 * int8_gemm_bound_s(m, s.dim, s.ffn_dim, peaks) + int8_gemm_bound_s(m, s.ffn_dim, s.dim, peaks)
    head = int8_gemm_bound_s(logits_rows, s.dim, s.vocab, peaks) if logits_rows else 0.0
    return s.n_layers * per_layer + head
