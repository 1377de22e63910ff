"""Ring attention: sequence parallelism over the shards of an sp axis.

Reference: ``agentainer_tpu/parallel/ring_attention.py`` — ``_ring_local``
and ``ring_attention``. Each shard holds one block of the sequence's
queries, keys and values; the key/value blocks rotate around the sp ring
(``collectives.ring_shift``, the reference's ``ppermute`` ``j -> j + 1``)
while every shard attends its queries over each visiting block, so full
attention runs over a sequence ``sp`` times longer than one shard holds.
Shard ``a`` (its index along the axis) holds positions ``[a·T', (a+1)·T')``
(``T' = T/sp``); at step ``i`` it holds the block that began on shard
``(a - i) mod sp``.

Two bodies compute it:

- the kernel ring (the forward): each visiting block goes through
  ``flash_prefill(..., return_lse=True)`` with the queries' positions
  shifted by the block's first global slot, as a shard of a
  sequence-sharded serving arena does (``parallel/flash_mesh.py``): the kernel's
  own mask (slot ``j`` visible iff ``j <= pos`` and ``j < T'``) is then the
  block's causal slice, and a block wholly in the future returns zeros and
  ``NEG_INF``, which weighs 0; without ``causal`` every query is put at the
  block's last slot. The blocks' rows are joined by their lse,
  ``sum_i exp(lse_i - LSE) o_i``, as ``flash_mesh._join_sp`` joins sp
  shards, in f32. On a CPU tensor ``flash_prefill`` is its plain version,
  so the CPU runs the card's seam;
- the plain ring (the backward, and the CPU's reference): the reference's
  ``_ring_local`` in torch, an online softmax over the visiting blocks in
  f32 with the causal mask at block granularity from global positions.

``ring_attention`` is a ``torch.autograd.Function``: the forward runs the
kernel ring and keeps q/k/v; the backward recomputes the plain ring under
autograd and takes its gradient (as ``ops/attention.trainable_causal_attention``
does for one device). The kernels have no backward, so no launch happens in
it. Inputs may be bf16; the training path is f32. With bf16 inputs each
block's rows are rounded to bf16 before the join (the reference keeps them
in f32 across its scan).
"""

from __future__ import annotations

import torch

from ..ops.cuda_attention import NEG_INF, flash_prefill
from .collectives import ring_shift
from .mesh import Mesh
from .sharding import shard_batch, unshard_tensor


def _ring_plain(qs, ks, vs, mesh: Mesh, axis: str, causal: bool) -> list[torch.Tensor]:
    """The reference's ``_ring_local`` for every shard at once: q/k/v
    ``[B, T', H|KV, hd]`` per shard → ``[B, T', H, hd]`` per shard."""
    n = mesh.shape[axis]
    b, t_loc, h, hd = qs[0].shape
    kv_heads = ks[0].shape[2]
    group = h // kv_heads
    scale = 1.0 / hd**0.5
    state = []
    for s, q in enumerate(qs):
        qf = q.float().reshape(b, t_loc, kv_heads, group, hd)
        q_pos = mesh.index(axis, s) * t_loc + torch.arange(t_loc, device=q.device)
        m = torch.full((b, kv_heads, group, t_loc), NEG_INF, device=q.device)
        state.append([qf, q_pos, m, torch.zeros_like(m), torch.zeros((b, t_loc, kv_heads, group, hd), device=q.device)])
    k_blk, v_blk = list(ks), list(vs)
    for i in range(n):
        for s, st in enumerate(state):
            qf, q_pos, m, l, o = st
            src = (mesh.index(axis, s) - i) % n
            scores = torch.einsum("btkgd,bskd->bkgts", qf, k_blk[s].float()) * scale
            if causal:
                kv_pos = src * t_loc + torch.arange(t_loc, device=qf.device)
                mask = kv_pos[None, :] <= q_pos[:, None]
                scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
            new_m = torch.maximum(m, scores.amax(dim=-1))
            corr = torch.exp(m - new_m)
            p = torch.exp(scores - new_m[..., None])
            st[2], st[3] = new_m, l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgts,bskd->btkgd", p, v_blk[s].float())
            st[4] = o * corr.permute(0, 3, 1, 2)[..., None] + pv
        if i < n - 1:
            k_blk, v_blk = ring_shift(k_blk, mesh, axis), ring_shift(v_blk, mesh, axis)
    outs = []
    for q, (_, _, _, l, o) in zip(qs, state):
        l = torch.clamp(l, min=1e-30)  # a row that saw nothing (never in causal self-attention)
        outs.append((o / l.permute(0, 3, 1, 2)[..., None]).reshape(b, t_loc, h, hd).to(q.dtype))
    return outs


def _ring_kernel(qs, ks, vs, mesh: Mesh, axis: str, causal: bool) -> list[torch.Tensor]:
    """The kernel ring (module docstring): ``sp`` ``flash_prefill`` lse
    calls a shard, joined by their lse in f32."""
    n = mesh.shape[axis]
    b, t_loc = qs[0].shape[:2]
    rows, lses = [[] for _ in qs], [[] for _ in qs]
    k_blk, v_blk = list(ks), list(vs)
    for i in range(n):
        for s, q in enumerate(qs):
            if causal:
                src = (mesh.index(axis, s) - i) % n
                first = (mesh.index(axis, s) - src) * t_loc  # the queries' first position, in the block's slots
                pos = first + torch.arange(t_loc, dtype=torch.int32, device=q.device)
            else:
                pos = torch.full((t_loc,), t_loc - 1, dtype=torch.int32, device=q.device)
            o, lse = flash_prefill(q, k_blk[s], v_blk[s], pos.expand(b, t_loc), return_lse=True)
            rows[s].append(o)
            lses[s].append(lse)
        if i < n - 1:
            k_blk, v_blk = ring_shift(k_blk, mesh, axis), ring_shift(v_blk, mesh, axis)
    outs = []
    for q, os_, ls in zip(qs, rows, lses):
        lse = torch.stack(ls)  # [sp, B, T', H]
        w = torch.exp(lse - torch.logsumexp(lse, dim=0))  # NEG_INF against a finite total: 0
        outs.append((torch.stack(os_).float() * w[..., None]).sum(0).to(q.dtype))
    return outs


class _RingAttention(torch.autograd.Function):
    """Kernel ring forward, plain ring recomputed for the backward."""

    @staticmethod
    def forward(ctx, meta, *qkv):
        ctx.meta = meta
        ctx.save_for_backward(*qkv)
        n = len(qkv) // 3
        with torch.no_grad():
            return tuple(_ring_kernel(qkv[:n], qkv[n : 2 * n], qkv[2 * n :], *meta))

    @staticmethod
    def backward(ctx, *grads):
        qkv = ctx.saved_tensors
        n = len(qkv) // 3
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in qkv]
            outs = _ring_plain(leaves[:n], leaves[n : 2 * n], leaves[2 * n :], *ctx.meta)
            return (None, *torch.autograd.grad(outs, leaves, grads))


def _split(x, mesh: Mesh, spec: tuple) -> list[torch.Tensor]:
    return shard_batch(x, mesh, spec) if isinstance(x, torch.Tensor) else list(x)


def ring_attention(q, k, v, mesh: Mesh, axis: str = "sp", causal: bool = True, batch_axis: str | None = None,
                   plain: bool = False):
    """Full-sequence attention with the sequence sharded over ``axis``.

    ``q``/``k``/``v`` are one list over every shard of the mesh (each shard's
    ``[B', T/sp, H', hd]`` / ``[B', T/sp, KV', hd]``: its batch rows, its
    sequence block, its heads; the ring runs within each group over
    ``axis``), and a list comes back; or the reference's global view, q
    ``[B, T, H, hd]`` and k/v ``[B, T, KV, hd]`` with the batch split over
    ``batch_axis``, cut and joined here. ``plain``: the plain ring forward
    (the card's check holds the kernel ring against it)."""
    spec = (batch_axis, axis, None, None)
    qs, ks, vs = (_split(x, mesh, spec) for x in (q, k, v))
    if plain:
        outs = _ring_plain(qs, ks, vs, mesh, axis, causal)
    else:
        outs = list(_RingAttention.apply((mesh, axis, causal), *qs, *ks, *vs))
    return unshard_tensor(outs, spec, mesh) if isinstance(q, torch.Tensor) else outs
