"""Ulysses sequence parallelism: all-to-all head scattering.

Reference: ``agentainer_tpu/parallel/ulysses.py`` — ``_ulysses_local`` and
``ulysses_attention``. The complement to the ring: two ``all_to_all``s
(``collectives.all_to_all``, the reference's ``lax.all_to_all(...,
tiled=True)``) move each shard's activations from sequence-sharded
``[B, T/s, H, hd]`` to head-sharded ``[B, T, H/s, hd]``, each shard runs
ordinary causal attention over the whole sequence for its own heads, and a
reverse all-to-all restores sequence sharding. ``s`` must divide the KV
heads (the GQA group ratio then holds on every shard).

Each shard's attention is ``ops/attention.trainable_causal_attention``: the
prefill kernel forward on the card (its plain version on the CPU) and the
plain attention's autograd recomputed for the backward; ``plain`` runs
``attention_reference`` instead (the card's check holds the kernel path
against it).
"""

from __future__ import annotations

import torch

from ..ops.attention import attention_reference, cache_mask, trainable_causal_attention
from .collectives import all_to_all
from .mesh import Mesh
from .ring_attention import _split
from .sharding import unshard_tensor


def ulysses_attention(q, k, v, mesh: Mesh, axis: str = "sp", causal: bool = True,
                      batch_axis: str | None = None, plain: bool = False):
    """The inputs and output as ``parallel/ring_attention.ring_attention``'s:
    one list over every shard, or the reference's global view."""
    sp = mesh.shape[axis]
    spec = (batch_axis, axis, None, None)
    qs, ks, vs = (_split(x, mesh, spec) for x in (q, k, v))
    if ks[0].shape[2] % sp != 0:
        raise ValueError(f"sp={sp} must divide n_kv_heads={ks[0].shape[2]} for Ulysses")
    # gather the sequence, scatter the heads → [B, T, H/s, hd]
    qs, ks, vs = (all_to_all(x, mesh, axis, split_dim=2, concat_dim=1) for x in (qs, ks, vs))
    outs = []
    for qh, kh, vh in zip(qs, ks, vs):
        b, t = qh.shape[:2]
        pos = torch.arange(t, dtype=torch.int32, device=qh.device) if causal else \
            torch.full((t,), t - 1, dtype=torch.int32, device=qh.device)
        pos = pos.expand(b, t)
        if plain:
            outs.append(attention_reference(qh, kh, vh, mask=cache_mask(pos, t)))
        else:
            outs.append(trainable_causal_attention(qh, kh, vh, pos))
    # gather the heads, scatter the sequence → [B, T/s, H, hd]
    outs = all_to_all(outs, mesh, axis, split_dim=1, concat_dim=2)
    return unshard_tensor(outs, spec, mesh) if isinstance(q, torch.Tensor) else outs
