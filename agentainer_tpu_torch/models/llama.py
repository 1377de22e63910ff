"""Llama-3-family transformer in PyTorch.

Reference: ``agentainer_tpu/models/llama.py`` — ``KVCache``,
``PagedKVCache``, ``init_params``, ``_mlp``, ``_attention_block`` (the
paged branch, the dense-cache branch and the no-cache causal branch),
``forward`` and ``greedy_decode``. MoE and the sequence-parallel hooks wait
for later slices.

Parameters keep the reference's tree: a dict whose ``layers`` entries carry
a leading ``[n_layers, ...]`` axis and whose matmul weights are stored
``[in, out]`` (``x @ w``), so a JAX ``init_params`` tree converts leaf for
leaf (models/convert.py). The reference's ``lax.scan`` over the stacked
layers is a Python loop here; each iteration slices one layer as a view
(an int8 ``QTensor`` leaf field by field, ``ops/quant.layer_slice``).
Every weight product goes through ``ops/quant.qmatmul``: ``x @ w`` for a
dense weight, the fused int8 kernel for a quantized one (the reference
dequantizes and leaves the fusion to XLA).

Rounding points follow the reference: norms and RoPE compute in f32 and
cast back, attention softmax is f32, logits are f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.attention import (
    attention_reference,
    cache_attention,
    causal_mask,
    flash_attention,
    paged_cache_attention,
    scatter_paged_kv,
)
from ..ops.norms import rms_norm
from ..ops.quant import embed_lookup, layer_slice, qmatmul
from ..ops.rope import apply_rope
from .configs import ModelConfig


class KVCache:
    """Static-shape KV arena: ``k``/``v`` are ``[L, B, S, KV, hd]``.

    The storage holds one spare slot past the arena, ``[L, B, S + 1, KV,
    hd]``: JAX's scatter silently DROPS writes at positions >= S (bucket
    padding can run past the arena end), while torch's ``index_put_`` raises
    on the CPU and asserts on the card. Out-of-range writes are redirected
    to the spare slot S, which attention never reads — the same effect
    without a host sync to filter them. ``k``/``v`` are views without it.

    ``rows`` (a device int tensor ``[B']``, see ``at_rows``) makes batch row
    b of a forward write and attend arena row ``rows[b]``: the arena row is
    read from device memory, so a CUDA graph of the forward serves
    whichever slot the buffer names."""

    def __init__(self, k_store: torch.Tensor, v_store: torch.Tensor, rows=None):
        self.k_store = k_store
        self.v_store = v_store
        self.rows = rows

    @staticmethod
    def create(
        cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16, device=None
    ) -> "KVCache":
        shape = (cfg.n_layers, batch, max_seq + 1, cfg.n_kv_heads, cfg.head_dim)
        return KVCache(
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
        )

    @property
    def k(self) -> torch.Tensor:
        return self.k_store[:, :, :-1]

    @property
    def v(self) -> torch.Tensor:
        return self.v_store[:, :, :-1]

    @property
    def max_seq(self) -> int:
        return self.k_store.shape[2] - 1

    def row(self, b: int) -> "KVCache":
        """Batch row ``b`` as a one-row cache VIEW: writes through it land in
        this arena (the reference slices the row and writes it back)."""
        return KVCache(self.k_store[:, b : b + 1], self.v_store[:, b : b + 1])

    def at_rows(self, rows: torch.Tensor) -> "KVCache":
        """The whole arena, addressed through ``rows`` (int32 ``[B']`` on the
        arena's device): batch row b of a forward is arena row rows[b]."""
        return KVCache(self.k_store, self.v_store, rows)

    def write(self, layer: int, positions: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
        """In-place scatter of this step's k/v [B, T, KV, hd] at per-row
        ``positions`` [B, T] (the reference's donated ``.at[].set``), into
        arena rows ``rows`` when set."""
        s = self.max_seq
        idx = torch.where((positions >= 0) & (positions < s), positions, s).long()
        b_idx = (
            torch.arange(k.shape[0], device=k.device) if self.rows is None else self.rows.long()
        )[:, None].expand_as(idx)
        self.k_store[layer].index_put_((b_idx, idx), k)
        self.v_store[layer].index_put_((b_idx, idx), v)


class PagedKVCache:
    """Block-table KV arena: pools ``k``/``v`` of ``[L, n_pages, page_size,
    KV, hd]``. A sequence owns a list of pages (its block-table row) instead
    of a dense arena row, so resident sessions are bounded by the pool, not
    by the batch width. Writes go through ``scatter_paged_kv`` in place."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor):
        self.k = k
        self.v = v

    @staticmethod
    def create(
        cfg: ModelConfig, n_pages: int, page_size: int, dtype=torch.bfloat16, device=None
    ) -> "PagedKVCache":
        shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
        return PagedKVCache(
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
        )


def init_params(
    cfg: ModelConfig, generator: torch.Generator, dtype=torch.bfloat16, device=None
) -> dict:
    """Random init (normal, 0.02 scale) from an explicit generator, filled
    one leading-axis slice at a time so the f32 staging stays one layer
    big. Checkpoint loading maps onto the same tree."""
    if cfg.is_moe:
        raise ValueError("MoE configs are not ported yet")
    d, hd = cfg.dim, cfg.head_dim
    L = cfg.n_layers

    def w(*shape, scale=0.02):
        out = torch.empty(shape, dtype=dtype, device=device)
        rows = out if len(shape) > 2 else out[None]
        for sl in rows:
            sl.copy_(
                torch.randn(sl.shape, generator=generator, dtype=torch.float32, device=device)
                * scale
            )
        return out

    layers = {
        "attn_norm": torch.ones((L, d), dtype=dtype, device=device),
        "wq": w(L, d, cfg.n_heads * hd),
        "wk": w(L, d, cfg.n_kv_heads * hd),
        "wv": w(L, d, cfg.n_kv_heads * hd),
        "wo": w(L, cfg.n_heads * hd, d),
        "mlp_norm": torch.ones((L, d), dtype=dtype, device=device),
        "w_gate": w(L, d, cfg.ffn_dim),
        "w_up": w(L, d, cfg.ffn_dim),
        "w_down": w(L, cfg.ffn_dim, d),
    }
    return {
        "embed": w(cfg.vocab_size, d),
        "layers": layers,
        "final_norm": torch.ones((d,), dtype=dtype, device=device),
        "lm_head": w(d, cfg.vocab_size),
    }


def _mlp(x: torch.Tensor, lp: dict) -> torch.Tensor:
    """SwiGLU."""
    gate = F.silu(qmatmul(x, lp["w_gate"]))
    return qmatmul(gate * qmatmul(x, lp["w_up"]), lp["w_down"])


def _attention_block(
    x: torch.Tensor,
    lp: dict,
    cfg: ModelConfig,
    positions: torch.Tensor,
    mask: torch.Tensor | None,
    cache: KVCache | PagedKVCache | None,
    layer: int,
    use_flash: bool,
    block_table: torch.Tensor | None = None,
) -> torch.Tensor:
    b, t, d = x.shape
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = qmatmul(h, lp["wq"]).reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = qmatmul(h, lp["wk"]).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    v = qmatmul(h, lp["wv"]).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is not None and block_table is not None:
        # paged arena: write through the block table into pool pages, then
        # attend over the lanes' pages (same masking rule, same numbers as
        # the dense branch below)
        scatter_paged_kv(cache.k[layer], cache.v[layer], k, v, block_table, positions)
        attn = paged_cache_attention(
            q, cache.k[layer], cache.v[layer], block_table, positions, use_kernel=use_flash
        )
    elif cache is not None:
        # scatter this step's K/V into the arena at per-sequence positions,
        # then attend over this layer's arena view
        cache.write(layer, positions, k, v)
        attn = cache_attention(
            q, cache.k[layer], cache.v[layer], positions, use_kernel=use_flash, rows=cache.rows
        )
    elif use_flash:
        attn = flash_attention(q, k, v, causal=True)
    else:
        attn = attention_reference(q, k, v, mask=mask)
    out = qmatmul(attn.reshape(b, t, cfg.n_heads * cfg.head_dim), lp["wo"])
    return x + out


def forward(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, T] int
    positions: torch.Tensor,  # [B, T] int
    cache: KVCache | PagedKVCache | None = None,
    use_flash: bool = True,
    block_table: torch.Tensor | None = None,  # [B, n_blocks] int
    last_index: torch.Tensor | None = None,  # [B] int
) -> torch.Tensor:
    """Returns logits [B, T, V] in f32; with ``last_index`` only row
    ``last_index[b]`` of each sequence goes through the final norm and
    ``lm_head``, and the logits are [B, 1, V] (a prefill chunk needs its last
    real token's only).

    With a cache: serves prefill (T = prompt chunk) and decode (T = 1) with
    per-sequence positions, writing K/V into ``cache`` IN PLACE (the
    reference returns an updated cache from donated buffers). With
    ``block_table`` the cache is a :class:`PagedKVCache` and every KV read
    and write goes through the table. Without a cache: pure causal
    self-attention. ``use_flash=False`` takes the plain attention path even
    where the kernels would run."""
    if cfg.is_moe:
        raise ValueError("MoE configs are not ported yet")
    x = embed_lookup(params["embed"], tokens)
    mask = None
    if cache is None and not use_flash:
        t = tokens.shape[1]
        mask = causal_mask(t, device=x.device).expand(tokens.shape[0], t, t)
    for layer in range(cfg.n_layers):
        lp = {k: layer_slice(v, layer) for k, v in params["layers"].items()}
        x = _attention_block(x, lp, cfg, positions, mask, cache, layer, use_flash, block_table)
        h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + _mlp(h, lp)
    if last_index is not None:
        x = x.gather(1, last_index.long()[:, None, None].expand(-1, 1, x.shape[-1]))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return qmatmul(x, params["lm_head"]).float()


@torch.inference_mode()
def greedy_decode(
    params: dict,
    cfg: ModelConfig,
    prompt: torch.Tensor,  # [B, Tp]
    max_new_tokens: int,
    cache_len: int,
    dtype=torch.bfloat16,
) -> torch.Tensor:
    """Reference generation loop: prefill, then one-token decode steps.
    Engine-grade batching lives in engine/llm.py; this is the simple path
    used by tests."""
    b, tp = prompt.shape
    dev = prompt.device
    cache = KVCache.create(cfg, b, cache_len, dtype=dtype, device=dev)
    positions = torch.arange(tp, device=dev).expand(b, tp)
    logits = forward(params, cfg, prompt, positions, cache)
    tok = torch.argmax(logits[:, -1], dim=-1)
    out = [tok]
    pos = torch.full((b,), tp, device=dev)
    for _ in range(max_new_tokens - 1):
        logits = forward(params, cfg, tok[:, None], pos[:, None], cache)
        tok = torch.argmax(logits[:, -1], dim=-1)
        out.append(tok)
        pos = pos + 1
    return torch.stack(out, dim=1)  # [B, max_new_tokens]
