"""Int8 weight-only quantization for serving (llama-tree aware).

Reference: ``agentainer_tpu/engine/quant.py`` — an own copy of
``_QUANT_KEYS``, ``quantize_params``, ``param_bytes_actual``,
``synthetic_quantized_params``, ``quantize_kv_pages`` and
``dequantize_kv_pages``.

Why: Llama-3-8B in bf16 is 16.06 GB of weights, and every decode step
streams all of them; weight-only int8 halves that (8.03 GB). Deploy with
``model.options.quant: int8``. Norm vectors keep the working dtype (tiny,
precision-critical). Every weight product of a quantized model runs
through the fused int8 kernel (``ops/quant.qmatmul``); no dense weight is
written out on the card.

What differs from the reference:

- quantization runs where the weights are: on the card, slice by slice,
  so the f32 work stays one layer slice big (the reference quantizes on
  the host, so that the dense model never reaches device memory; here a
  checkpoint load quantizes each slice right after it lands,
  ``engine/hf_convert.py``);
- ``synthetic_quantized_params`` draws its int8 weights with
  ``torch.randint`` from a ``torch.Generator`` straight into device memory:
  the reference's tree, shapes, dtypes, range and scale constant, not its
  values (threefry's bits are JAX's own);
- with ``mesh=`` (``quantize_params`` and ``synthetic_quantized_params``)
  the tree comes back as per-shard int8 leaves
  (``parallel/sharding.shard_params``: ``q`` on the dense weight's spec,
  ``scale`` with its contraction axis whole), quantized whole first, so
  every shard's bits are the unsharded quantization's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.quant import QTensor, quantize_array

QUANT_SCHEMES = ("int8",)
# matmul weights to quantize, by tree key; norms keep their dtype
_QUANT_KEYS = {
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "router",
    "embed", "lm_head",
}
# a synthetic weight's scale: absmax 127 ↔ a 0.02-std init's scale, so the
# dequantized weights are uniform in ±0.02 (std ≈ 0.012)
SYNTHETIC_SCALE = 0.02 / 127.0


def quantize_params(params: dict, dtype=torch.bfloat16, mesh=None):
    """Quantize the matmul weights of a ``models/llama.py`` tree where they
    lie, one layer slice at a time; norms come into ``dtype``. With
    ``mesh``, the per-shard trees."""
    out: dict = {}
    for key, val in params.items():
        if isinstance(val, dict):
            out[key] = quantize_params(val, dtype)
        elif key in _QUANT_KEYS:
            out[key] = quantize_array(val, dtype)
        else:
            out[key] = val.to(dtype)
    return _sharded(out, mesh)


def _sharded(params: dict, mesh):
    if mesh is None:
        return params
    from ..parallel.sharding import shard_params

    return shard_params(params, mesh)


def _tensors(params):
    """Every tensor of a (possibly quantized) tree: a ``QTensor`` gives its
    ``q`` and its ``scale``."""
    if isinstance(params, dict):
        for v in params.values():
            yield from _tensors(v)
    elif isinstance(params, QTensor):
        yield from params
    else:
        yield params


def param_bytes_actual(params: dict) -> int:
    """Byte footprint of the (possibly quantized) tree."""
    return sum(t.numel() * t.element_size() for t in _tensors(params))


def synthetic_quantized_params(
    cfg, dtype=torch.bfloat16, device=None, generator: torch.Generator | None = None, mesh=None
):
    """Benchmark-grade random int8 tree generated ON the device: perf work
    needs int8-shaped, non-degenerate weights, not trained ones, and an 8B
    model then loads in seconds with no host init and no host-to-device
    copy. Deploy with ``model.options: {quant: int8, synthetic: true}``.
    ``generator`` (on ``device``) seeds the draw. With ``mesh``, the
    per-shard trees, cut from the one draw."""
    from ..models.configs import ModelConfig

    assert isinstance(cfg, ModelConfig)
    d, hd, L = cfg.dim, cfg.head_dim, cfg.n_layers
    shapes = {
        "wq": (L, d, cfg.n_heads * hd),
        "wk": (L, d, cfg.n_kv_heads * hd),
        "wv": (L, d, cfg.n_kv_heads * hd),
        "wo": (L, cfg.n_heads * hd, d),
    }
    if cfg.is_moe:
        shapes.update(
            {
                "router": (L, d, cfg.n_experts),
                "w_gate": (L, cfg.n_experts, d, cfg.ffn_dim),
                "w_up": (L, cfg.n_experts, d, cfg.ffn_dim),
                "w_down": (L, cfg.n_experts, cfg.ffn_dim, d),
            }
        )
    else:
        shapes.update(
            {
                "w_gate": (L, d, cfg.ffn_dim),
                "w_up": (L, d, cfg.ffn_dim),
                "w_down": (L, cfg.ffn_dim, d),
            }
        )

    def qleaf(shape) -> QTensor:
        q = torch.randint(-127, 128, shape, dtype=torch.int8, generator=generator, device=device)
        scale_shape = shape[:-2] + (1,) + shape[-1:]
        return QTensor(q=q, scale=torch.full(scale_shape, SYNTHETIC_SCALE, dtype=dtype, device=device))

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    layers: dict = {"attn_norm": ones((L, d)), "mlp_norm": ones((L, d))}
    for name, shape in shapes.items():
        layers[name] = qleaf(shape)
    return _sharded({
        "embed": qleaf((cfg.vocab_size, d)),
        "layers": layers,
        "final_norm": ones((d,)),
        "lm_head": qleaf((d, cfg.vocab_size)),
    }, mesh)


# -- KV page quantization (tiered KV hierarchy's host tier) --------------
#
# Host-side int8 with PER-PAGE scales (one scale per layer × page × KV
# head): a parked session's KV prefix shrinks 2-4x in host RAM versus the
# exact-dtype staging, at a rounding error bounded per page rather than
# per tensor — a single outlier page cannot flatten every other page's
# resolution. Pure numpy on purpose: tier transfers are data movement and
# never touch the device. (The port's KV tiering is later work; these
# carry over with the module.)


def quantize_kv_pages(arr, page_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Quantize a position-trimmed KV prefix [L, pos, KV, hd] to int8
    pages. Returns (q [L, n_pages, page_size, KV, hd] int8, scale
    [L, n_pages, 1, KV, 1] float32); the tail page is zero-padded (the
    padding never dequantizes into the live prefix)."""
    a = np.asarray(arr).astype(np.float32)
    L, pos = a.shape[0], a.shape[1]
    n = max(1, (pos + page_size - 1) // page_size)
    pad = n * page_size - pos
    if pad:
        widths = [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2)
        a = np.pad(a, widths)
    paged = a.reshape(L, n, page_size, *a.shape[2:])
    absmax = np.max(np.abs(paged), axis=(2, 4), keepdims=True)
    scale = (absmax / 127.0).astype(np.float32)
    scale[scale == 0.0] = 1.0  # all-zero page: any scale round-trips zeros
    q = np.clip(np.rint(paged / scale), -127, 127).astype(np.int8)
    return q, scale


def dequantize_kv_pages(q: np.ndarray, scale: np.ndarray, position: int) -> np.ndarray:
    """Inverse of quantize_kv_pages: int8 pages + per-page scales back to
    a float32 [L, position, KV, hd] prefix (the caller casts into the
    cache dtype at restore)."""
    deq = q.astype(np.float32) * scale
    L, n, page_size = deq.shape[0], deq.shape[1], deq.shape[2]
    return deq.reshape(L, n * page_size, *deq.shape[3:])[:, :position]
