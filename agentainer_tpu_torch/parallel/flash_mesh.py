"""Attention kernels under a mesh: each tp shard on its own heads.

Reference: ``agentainer_tpu/parallel/flash_mesh.py`` —
``make_meshed_cache_attention`` and ``supported``. Attention is
embarrassingly parallel over heads, so each tp shard runs the port's
kernels (``ops/attention.cache_attention``/``paged_cache_attention``: the
hand-written kernels on the card, their plain versions on the CPU) on its
local query heads against its own arena or pool, and no collective is
needed inside. The GQA group ratio is the same on every shard.

This is the serving forward's attention (``models/llama.forward``), on a
mesh and on one device alike (one shard). The reference's training
wrappers wait for the training slice, and its interpret switch has no
counterpart: the port has no interpret mode.
"""

from __future__ import annotations

from ..ops.attention import cache_attention, paged_cache_attention, scatter_paged_kv
from ..ops.cuda_attention import kernel_supported


def make_meshed_cache_attention(paged: bool = False):
    """``attend(qs, news, caches, layer, positions, block_tables=None,
    use_kernel=True)`` → one ``[B, T, H/tp, hd]`` per shard, each on its
    shard's device. Per shard ``s``: ``qs[s]`` are its query heads,
    ``news[s]`` = (k, v) ``[B, T, KV/tp, hd]`` the step's rows, written
    into layer ``layer`` of its cache ``caches[s]`` (a ``KVCache``, or,
    ``paged``, a ``PagedKVCache`` addressed through the replicated
    ``block_tables[s]``) at ``positions[s]``, in place; then its queries
    attend over that layer."""

    def attend(qs, news, caches, layer, positions, block_tables=None, use_kernel=True):
        outs = []
        for s, (q, (k, v), cache, pos) in enumerate(zip(qs, news, caches, positions)):
            if paged:
                table = block_tables[s]
                scatter_paged_kv(cache.k[layer], cache.v[layer], k, v, table, pos)
                outs.append(
                    paged_cache_attention(q, cache.k[layer], cache.v[layer], table, pos, use_kernel=use_kernel)
                )
            else:
                cache.write(layer, pos, k, v)
                outs.append(
                    cache_attention(
                        q, cache.k[layer], cache.v[layer], pos, use_kernel=use_kernel, rows=cache.rows
                    )
                )
        return outs

    return attend


def supported(cfg, tp: int) -> bool:
    """The kernels' shape constraints hold per shard under a tp split."""
    return (
        cfg.n_kv_heads % tp == 0
        and cfg.n_heads % tp == 0
        and kernel_supported(cfg.n_heads // tp, cfg.n_kv_heads // tp, cfg.head_dim)
    )
