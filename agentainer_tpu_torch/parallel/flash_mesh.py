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
mesh and on one device alike (one shard).

The training half: ``make_meshed_causal_attention`` (forward only) and
``make_trainable_causal_attention`` give the causal self-attention without
a cache that ``models/llama.forward`` runs on each shard's local heads (tp)
and batch rows (dp), the whole sequence on every shard (sp == 1: an sp
mesh takes ``ring_attention`` or ``ulysses``): the prefill kernel, and for
training ``ops/attention.trainable_causal_attention``'s recomputed plain
backward. The reference wraps them in ``shard_map``; here each shard
already holds its own tensors. ``make_gathered_causal_attention`` is a
mesh-level form, ``attend(qs, ks, vs)`` over every shard's list (the
forward's ``seq_attn_impl``). ``resolve_mesh_flash`` is the reference's one
policy for both, without its einsum branch: the kernels on the card
wherever ``supported(cfg, tp)`` holds, a refusal on the card where it does
not, and the plain versions on the CPU. The reference's ``interpret``
switch and ``ATPU_FORCE_MESH_FLASH`` (Pallas interpret mode on the CPU)
have no counterpart: the port has no interpret mode, and on a CPU tensor
every wrapper already runs the kernels' plain versions.
"""

from __future__ import annotations

import torch

from ..ops.attention import cache_attention, paged_cache_attention, scatter_paged_kv, trainable_causal_attention
from ..ops.cuda_attention import flash_attention_causal, kernel_supported
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


def _whole_sequence(mesh) -> None:
    if mesh.shape["sp"] > 1:
        raise ValueError(f"{mesh}: the sequence is sharded over sp; use ring_attention or ulysses_attention")


def make_meshed_causal_attention(mesh):
    """Causal self-attention for the no-cache path, forward only: the
    per-shard ``attend(q, k, v)`` → ``[B', T, H/tp, hd]``, the prefill
    kernel at positions ``arange(T)`` on a shard's heads and rows
    (sp == 1)."""
    _whole_sequence(mesh)
    return flash_attention_causal


def make_trainable_causal_attention(mesh):
    """Differentiable meshed flash for the training path: the per-shard
    ``trainable_causal_attention`` (the kernel forward, no score tensor
    kept; the plain attention's autograd recomputed for the backward)."""
    _whole_sequence(mesh)
    return trainable_causal_attention


def make_gathered_causal_attention(mesh):
    """Causal self-attention over a sequence-sharded mesh without a ring
    (the training step's ``seq_attn="none"``): k and v all-gathered over
    sp, each shard's queries at their global positions (its sp index
    times its block length on) through ``trainable_causal_attention``."""

    def attend(qs, ks, vs):
        ks, vs = (all_gather(x, mesh, "sp", dim=1) for x in (ks, vs))
        outs = []
        for s, (q, k, v) in enumerate(zip(qs, ks, vs)):
            b, t = q.shape[:2]
            pos = mesh.index("sp", s) * t + torch.arange(t, dtype=torch.int32, device=q.device)
            outs.append(trainable_causal_attention(q, k, v, pos.expand(b, t)))
        return outs

    return attend


def resolve_mesh_flash(cfg, tp: int, devices) -> bool:
    """True when the shards' attention runs the kernels (every device a
    card and ``supported(cfg, tp)``), False on the CPU (their plain
    versions); a card with a per-shard head the kernels do not take
    raises, as ``LLMEngine.create`` does, instead of running plain
    attention on the card."""
    on_card = any(torch.device(d).type == "cuda" for d in devices)
    if on_card and not supported(cfg, tp):
        raise ValueError(
            f"{cfg.name}: no attention kernel for {cfg.n_heads // max(tp, 1)} query / "
            f"{cfg.n_kv_heads // max(tp, 1)} kv heads of head_dim {cfg.head_dim} on a tp={tp} shard"
        )
    return on_card
