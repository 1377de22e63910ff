"""Attention ops — plain PyTorch reference implementations + CUDA kernel
dispatch.

Reference: ``agentainer_tpu/ops/attention.py``: ``attention_reference``,
``causal_mask``, ``cache_mask``, ``flash_attention``, ``cache_attention``
and the paged half, ``gather_pages``, ``scatter_paged_kv`` and
``paged_cache_attention``; ``trainable_causal_attention`` is the one-device
body of ``agentainer_tpu/parallel/flash_mesh.py``'s
``make_trainable_causal_attention``.

Dispatch: tensors on the card go to the hand-written kernels
(ops/cuda_attention.py), whose wrappers raise for a head shape the kernels do
not take (``kernel_supported``); only CPU tensors, or an explicit
``use_kernel=False`` (the reference's ``use_pallas=False``), take the plain
reference path. The reference also gives way to plain XLA for an unsupported
head on the TPU; the port raises instead, so nothing on the card runs plain
attention unnoticed. Softmax runs in float32; GQA groups query heads over
shared KV heads instead of repeating K/V.
"""

from __future__ import annotations

import torch

from .cuda_attention import (
    flash_attention_causal,
    flash_decode,
    flash_prefill,
    flash_prefill_plain,
    fused_paged_flash_decode,
    fused_paged_flash_prefill,
)

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


def _on_card(x: torch.Tensor) -> bool:
    return x.device.type != "cpu"


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor | None = None,
    causal: bool = False,
) -> torch.Tensor:
    """Dispatch: the prefill kernel on the card for causal no-cache
    attention, the plain reference for CPU tensors or an explicit mask."""
    if causal and mask is None and _on_card(q):
        return flash_attention_causal(q, k, v)
    if causal and mask is None:
        mask = causal_mask(q.shape[1], device=q.device)
    return attention_reference(q, k, v, mask=mask)


class _TrainableCausalAttention(torch.autograd.Function):
    """The reference's ``custom_vjp`` (``parallel/flash_mesh.py:81-122``):
    the forward is the prefill kernel (positions ``arange(T)``, or the
    queries' own) and keeps only q/k/v; the backward recomputes
    ``attention_reference`` under the same mask and takes its gradient. No
    ``[B, KV, G, T, S]`` score tensor is kept between the passes; the
    backward materializes one layer's while it runs."""

    @staticmethod
    def forward(ctx, q, k, v, positions):
        ctx.save_for_backward(q, k, v, positions)
        return flash_prefill(q.detach(), k.detach(), v.detach(), positions)

    @staticmethod
    def backward(ctx, g):
        q, k, v, positions = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            out = attention_reference(*leaves, mask=cache_mask(positions, k.shape[1]))
            return (*torch.autograd.grad(out, leaves, g), None)


def trainable_causal_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor | None = None
) -> torch.Tensor:
    """Causal GQA self-attention with a gradient: q ``[B, T, H, hd]``, k/v
    ``[B, S, KV, hd]`` → ``[B, T, H, hd]``; query row t sees slot j iff j <=
    ``positions[b, t]`` (int32 ``[B, T]``; ``arange(T)`` by default, S = T:
    self-attention; a sequence shard's queries at their global positions
    against the whole sequence's k/v otherwise). The forward runs
    ``flash_prefill`` (on a CPU tensor its plain version, so the CPU runs the
    same autograd seam as the card); on the card a head shape the kernel
    does not take raises, with no fallback to plain attention. The backward
    is the plain attention's autograd, recomputed from q/k/v, as in the
    reference."""
    if positions is None:
        b, t = q.shape[0], q.shape[1]
        positions = torch.arange(t, dtype=torch.int32, device=q.device).expand(b, t)
    return _TrainableCausalAttention.apply(q, k, v, positions.to(torch.int32))


def cache_attention(
    q: torch.Tensor,  # [B, T, H, hd]
    ck: torch.Tensor,  # [B, S, KV, hd] arena (slots >= positions are unwritten)
    cv: torch.Tensor,  # [B, S, KV, hd]
    positions: torch.Tensor,  # [B, T] int per-sequence absolute positions
    use_kernel: bool = True,
    rows: torch.Tensor | None = None,  # [B] int arena row of each sequence
    return_lse: bool = False,
):
    """Attention over the KV arena: row t sees slot j iff j <= positions[b,t].

    The serving hot path (ragged cached prefill and T == 1 decode). On the
    card it sends T > 1 to ``flash_prefill`` and T == 1 to
    ``flash_decode``; on the CPU — or with ``use_kernel=False``, the
    reference's ``use_pallas=False`` — it materializes ``cache_mask`` and
    runs the plain reference. ``rows`` sends sequence b to arena row
    rows[b] (the prefill kernel reads it on the device; elsewhere the rows
    are gathered first). ``return_lse`` (a shard of a sequence-sharded
    arena, ``parallel/flash_mesh.py``): also each row's log-sum-exp, f32
    ``[B, T, H]``, from the kernels' entries or, off the card, their plain
    versions (``ops/cuda_attention.py``)."""
    if rows is not None and not (use_kernel and _on_card(q) and q.shape[1] > 1):
        ck, cv = ck.index_select(0, rows.long()), cv.index_select(0, rows.long())
        rows = None
    if use_kernel and _on_card(q):
        pos = positions.to(torch.int32)
        if rows is not None:
            return flash_prefill(q, ck, cv, pos, rows.to(torch.int32), return_lse=return_lse)
        if q.shape[1] == 1:
            got = flash_decode(q[:, 0], ck, cv, pos[:, 0], return_lse=return_lse)
            return (got[0][:, None], got[1][:, None]) if return_lse else got[:, None]
        return flash_prefill(q, ck, cv, pos, return_lse=return_lse)
    if return_lse:
        return flash_prefill_plain(q, ck, cv, positions, return_lse=True)
    return attention_reference(q, ck, cv, mask=cache_mask(positions, ck.shape[1]))


# -- paged KV (block-table) variants ------------------------------------
#
# The paged arena replaces per-sequence arena rows with a global pool of
# fixed-size pages ``[P, page_size, KV, hd]`` plus a per-lane block table
# ``[B, n_blocks]`` of physical page ids. Logical position ``p`` of lane
# ``b`` lives at ``(block_table[b, p // page_size], p % page_size)``. The
# gathered view is laid out exactly like a dense arena row, so the plain
# path runs the same math as the dense one.


def gather_pages(
    pool_k: torch.Tensor,  # [P, page_size, KV, hd]
    pool_v: torch.Tensor,
    block_table: torch.Tensor,  # [B, n_blocks] int physical page ids
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each lane's logical arena from its pages: ``[B, n_blocks * page_size,
    KV, hd]`` copies."""
    b, nb = block_table.shape
    ps = pool_k.shape[1]
    idx = block_table.long()
    k = pool_k[idx].reshape(b, nb * ps, *pool_k.shape[2:])
    v = pool_v[idx].reshape(b, nb * ps, *pool_v.shape[2:])
    return k, v


def scatter_paged_kv(
    pool_k: torch.Tensor,  # [P, page_size, KV, hd], written IN PLACE
    pool_v: torch.Tensor,
    k_new: torch.Tensor,  # [B, T, KV, hd]
    v_new: torch.Tensor,
    block_table: torch.Tensor,  # [B, n_blocks]
    positions: torch.Tensor,  # [B, T] int
) -> None:
    """Write this step's K/V through the block table into pool pages, in
    place (the reference returns updated pools). Positions past the logical
    arena (bucket padding) clamp to its last slot ``S - 1``, the lane's
    scratch slot that no live query attends; the clamp keeps every write in
    range, so the pool needs no spare slot (the dense ``KVCache`` does)."""
    ps = pool_k.shape[1]
    s = block_table.shape[1] * ps
    cpos = torch.clamp(positions, max=s - 1).long()
    b_idx = torch.arange(positions.shape[0], device=positions.device)[:, None]
    pages = block_table.long()[b_idx, cpos // ps]
    offs = cpos % ps
    pool_k.index_put_((pages, offs), k_new)
    pool_v.index_put_((pages, offs), v_new)


def paged_cache_attention(
    q: torch.Tensor,  # [B, T, H, hd]
    pool_k: torch.Tensor,  # [P, page_size, KV, hd]
    pool_v: torch.Tensor,
    block_table: torch.Tensor,  # [B, n_blocks]
    positions: torch.Tensor,  # [B, T]
    use_kernel: bool = True,
) -> torch.Tensor:
    """Attention over a paged arena. On the card it sends T == 1 to
    ``fused_paged_flash_decode`` and T > 1 to ``fused_paged_flash_prefill``,
    which read the pages through the table for any page size; on the CPU —
    or with ``use_kernel=False``, the reference's ``use_pallas=False`` — it
    gathers the lanes' pages and runs the plain reference under
    ``cache_mask``."""
    if use_kernel and _on_card(q):
        pos = positions.to(torch.int32)
        table = block_table.to(torch.int32)
        if q.shape[1] == 1:
            return fused_paged_flash_decode(q[:, 0], pool_k, pool_v, table, pos[:, 0])[:, None]
        return fused_paged_flash_prefill(q, pool_k, pool_v, table, pos)
    ck, cv = gather_pages(pool_k, pool_v, block_table)
    return attention_reference(q, ck, cv, mask=cache_mask(positions, ck.shape[1]))
