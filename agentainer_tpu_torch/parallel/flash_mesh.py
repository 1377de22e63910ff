"""Attention kernels under a mesh: each tp shard on its own heads, each sp
shard on its own slots.

Reference: ``agentainer_tpu/parallel/flash_mesh.py`` —
``make_meshed_cache_attention`` and ``supported``. Attention is
embarrassingly parallel over heads, so each tp shard runs the port's
kernels (``ops/attention.cache_attention``/``paged_cache_attention``: the
hand-written kernels on the card, their plain versions on the CPU) on its
local query heads against its own arena or pool, and no collective is
needed inside. The GQA group ratio is the same on every shard.

A sequence-sharded arena (sp > 1; ``parallel/sharding.cache_spec(sp=True)``)
is where the port departs from the reference. The reference keeps such an
arena away from its Pallas kernels: its sp engine runs the einsum path and
XLA derives the partial-softmax combine from the sharding annotations. The
port has no plain attention on the card, so its counterpart runs the
hand-written kernels on each shard and joins the shards itself: shard ``j``
holds slots ``[j·S', (j+1)·S')`` of every row (``S' = S/sp``) and sees its
step's positions shifted by ``-j·S'``, so the kernels' own mask (slot ``i``
visible iff ``i <= pos`` and ``i < S'``) is exactly the shard's causal
slice; it writes only those of the step's rows whose slots it holds (a
prefill chunk may straddle two shards: the others land in the shard's spare
slot, which nothing reads), attends through the kernels' ``lse`` entry,
and the shards' normalized rows are joined over sp as
``sum_j exp(lse_j - LSE) o_j`` with ``LSE = log(sum_j exp(lse_j))``: one
``all_gather`` of the rows' lse (``[B, T, H/tp]`` f32, small) and one
``all_reduce`` of the weighted rows, in f32. A shard whose rows see no slot
returns zeros and ``NEG_INF``, which weighs 0.

This is the serving forward's attention (``models/llama.forward``), on a
mesh and on one device alike (one shard). The reference's training
wrappers wait for the training slice, and its interpret switch has no
counterpart: the port has no interpret mode.
"""

from __future__ import annotations

import torch

from ..ops.attention import cache_attention, paged_cache_attention, scatter_paged_kv
from ..ops.cuda_attention import kernel_supported
from .collectives import all_gather, all_reduce


def _join_sp(outs, lses, mesh):
    """Each shard's rows ``outs[s]`` ``[B, T, H', hd]`` and their
    log-sum-exp ``lses[s]`` ``[B, T, H']`` joined over its sp group
    (module docstring); every shard gets the joined rows in its rows'
    dtype."""
    gathered = all_gather([x[None] for x in lses], mesh, "sp", dim=0)  # [sp, B, T, H'] each
    parts = []
    for s, (o, g) in enumerate(zip(outs, gathered)):
        w = torch.exp(lses[s] - torch.logsumexp(g, dim=0))  # NEG_INF against a finite total: 0
        parts.append(o.float() * w[..., None])
    return [x.to(o.dtype) for x, o in zip(all_reduce(parts, mesh, "sp"), outs)]


def make_meshed_cache_attention(paged: bool = False, mesh=None):
    """``attend(qs, news, caches, layer, positions, block_tables=None,
    use_kernel=True)`` → one ``[B, T, H/tp, hd]`` per shard, each on its
    shard's device. Per shard ``s``: ``qs[s]`` are its query heads,
    ``news[s]`` = (k, v) ``[B, T, KV/tp, hd]`` the step's rows, written
    into layer ``layer`` of its cache ``caches[s]`` (a ``KVCache``, or,
    ``paged``, a ``PagedKVCache`` addressed through the replicated
    ``block_tables[s]``) at ``positions[s]``, in place; then its queries
    attend over that layer. With ``mesh`` of sp > 1 (dense only) each
    shard holds its sp slice of the slots, and the rows are joined over sp
    (module docstring)."""
    sp = mesh.shape["sp"] if mesh is not None else 1

    def attend(qs, news, caches, layer, positions, block_tables=None, use_kernel=True):
        outs, lses = [], []
        for s, (q, (k, v), cache, pos) in enumerate(zip(qs, news, caches, positions)):
            if paged:
                table = block_tables[s]
                scatter_paged_kv(cache.k[layer], cache.v[layer], k, v, table, pos)
                outs.append(
                    paged_cache_attention(q, cache.k[layer], cache.v[layer], table, pos, use_kernel=use_kernel)
                )
            elif sp > 1:
                local = pos - mesh.index("sp", s) * cache.max_seq
                cache.write(layer, local, k, v)
                o, lse = cache_attention(
                    q, cache.k[layer], cache.v[layer], local, use_kernel=use_kernel, rows=cache.rows,
                    return_lse=True,
                )
                outs.append(o)
                lses.append(lse)
            else:
                cache.write(layer, pos, k, v)
                outs.append(
                    cache_attention(
                        q, cache.k[layer], cache.v[layer], pos, use_kernel=use_kernel, rows=cache.rows
                    )
                )
        return _join_sp(outs, lses, mesh) if lses else outs

    return attend


def supported(cfg, tp: int) -> bool:
    """The kernels' shape constraints hold per shard under a tp split (sp
    does not change the head split)."""
    return (
        cfg.n_kv_heads % tp == 0
        and cfg.n_heads % tp == 0
        and kernel_supported(cfg.n_heads // tp, cfg.n_kv_heads // tp, cfg.head_dim)
    )
