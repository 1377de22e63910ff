"""Sharding rules: which axis of each leaf splits over which mesh axis.

Reference: ``agentainer_tpu/parallel/sharding.py`` — ``param_specs``,
``scale_spec``, ``qtensor_sharding``/``param_shardings_for`` (int8
leaves), ``cache_specs`` and ``shard_params``; and from
``agentainer_tpu/parallel/pipeline.py`` ``pipeline_layer_specs`` and
``pipeline_param_specs``. Megatron-style tensor parallelism: column-
parallel QKV/gate/up, row-parallel output/down, vocab-sharded
embed/lm_head; expert stacks also split their expert axis over ``ep``; a
sequence-parallel arena splits its slots over ``sp``; a pipeline splits
the layer axis of the weights and of the arena over ``pp`` and the
vocabulary of embed/lm_head over pp. A spec is a tuple with one entry per
axis of the leaf: a mesh axis name, or None for an axis kept whole (the
reference's ``PartitionSpec``).

Where the reference hands the specs to ``jax.device_put`` and GSPMD, the
port cuts every leaf once at build: ``shard_params`` gives one params dict
per shard, each leaf a contiguous tensor on its shard's device. A leaf
that splits over no axis of size > 1 is shared by the shards on one device
(the weights are read-only) and copied to each other device.
"""

from __future__ import annotations

import torch

from ..ops.quant import QTensor
from .mesh import Mesh

Spec = tuple


def param_specs(moe: bool) -> dict:
    """Spec tree matching models/llama.init_params' structure."""
    layers = {
        "attn_norm": (None, None),
        "wq": (None, None, "tp"),  # column-parallel: heads split over tp
        "wk": (None, None, "tp"),
        "wv": (None, None, "tp"),
        "wo": (None, "tp", None),  # row-parallel: all-reduce after
        "mlp_norm": (None, None),
    }
    if moe:
        layers.update(
            {
                "router": (None, None, None),
                "w_gate": (None, "ep", None, "tp"),
                "w_up": (None, "ep", None, "tp"),
                "w_down": (None, "ep", "tp", None),
            }
        )
    else:
        layers.update(
            {
                "w_gate": (None, None, "tp"),
                "w_up": (None, None, "tp"),
                "w_down": (None, "tp", None),
            }
        )
    return {
        "embed": ("tp", None),  # vocab-sharded
        "layers": layers,
        "final_norm": (None,),
        "lm_head": (None, "tp"),
    }


def scale_spec(spec: Spec) -> Spec:
    """Spec for a QTensor's ``scale``: same rank as the weight but size 1 on
    the contraction axis (-2), so any mesh axis assigned there drops — the
    scale replicates across the shards that split the contraction."""
    parts = list(spec)
    if len(parts) >= 2:
        parts[-2] = None
    return tuple(parts)


def pipeline_layer_specs(moe: bool) -> dict:
    """The ``layers`` subtree with its leading layer axis over pp: each stage
    holds its ``L/pp`` layers whole (serve-time pp composes with no other
    axis, so the reference's ``tp=True`` widths are not taken here)."""
    return {k: ("pp", *([None] * (len(v) - 1))) for k, v in param_specs(moe)["layers"].items()}


def pipeline_param_specs(moe: bool) -> dict:
    """The tree under a pp mesh: layers staged; ``embed`` rows and
    ``lm_head`` columns vocab-sharded over pp, so no stage replicates the
    two V × D matrices."""
    return {
        "embed": ("pp", None),
        "layers": pipeline_layer_specs(moe),
        "final_norm": (None,),
        "lm_head": (None, "pp"),
    }


def specs_for(mesh: Mesh, moe: bool) -> dict:
    """The spec tree a mesh cuts the params by: the pipeline's on a pp
    mesh, else the tp × ep one."""
    return pipeline_param_specs(moe) if mesh.shape["pp"] > 1 else param_specs(moe)


def cache_spec(sp: bool = False) -> Spec:
    """Dense KV arena ``[L, B, S, KV, hd]``: batch over dp, kv heads over tp,
    and with ``sp`` the slot axis over sp, so each shard holds ``S/sp`` of
    every row (the reference's ``cache_specs``)."""
    return (None, "dp", "sp" if sp else None, "tp", None)


def pipeline_cache_spec() -> Spec:
    """The arena under a pp mesh: its layer axis staged like the weights'
    (the reference's ``P("pp", None, None, None, None)``)."""
    return ("pp", None, None, None, None)


def pool_spec() -> Spec:
    """Paged pool ``[L, P, page, KV, hd]``: kv heads over tp; page ids are
    global, so the page axis stays whole (block tables replicate)."""
    return (None, None, None, "tp", None)


def shard_tensor(x: torch.Tensor, spec: Spec, mesh: Mesh, shard: int) -> torch.Tensor:
    """Shard ``shard``'s slice of ``x`` under ``spec``, contiguous, on its
    device (``x`` itself where nothing splits and it is already there)."""
    if len(spec) != x.dim():
        raise ValueError(f"spec {spec} does not fit a leaf of shape {tuple(x.shape)}")
    for dim, axis in enumerate(spec):
        n = mesh.shape[axis] if axis is not None else 1
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"axis {dim} of {tuple(x.shape)} does not split over {axis}={n}")
        size = x.shape[dim] // n
        x = x.narrow(dim, mesh.index(axis, shard) * size, size)
    return x.to(mesh.device_list[shard]).contiguous()


def shard_leaf(leaf, spec: Spec, mesh: Mesh, shard: int):
    """A dense leaf, or an int8 ``QTensor`` (``q`` on the dense spec,
    ``scale`` on ``scale_spec``)."""
    if isinstance(leaf, QTensor):
        return QTensor(
            q=shard_tensor(leaf.q, spec, mesh, shard),
            scale=shard_tensor(leaf.scale, scale_spec(spec), mesh, shard),
        )
    return shard_tensor(leaf, spec, mesh, shard)


def _is_moe(params: dict) -> bool:
    return "router" in params["layers"]


def shard_params(params: dict, mesh: Mesh, moe: bool | None = None) -> list[dict]:
    """One params dict per shard of ``mesh``, in shard order, cut once
    (``moe`` defaults to whether the tree has a router)."""

    def cut(tree, specs, s):
        return {
            k: cut(v, specs[k], s) if isinstance(v, dict) else shard_leaf(v, specs[k], mesh, s)
            for k, v in tree.items()
        }

    specs = specs_for(mesh, _is_moe(params) if moe is None else moe)
    return [cut(params, specs, s) for s in range(mesh.size)]


def unsharded_bytes(shards: list[dict], mesh: Mesh) -> int:
    """The bytes of the tree ``shards`` were cut from (what the reference's
    footprint of a sharded tree counts): each leaf of shard 0 times the
    pieces its spec cuts it into."""

    def pieces(spec) -> int:
        n = 1
        for axis in spec:
            n *= mesh.shape[axis] if axis is not None else 1
        return n

    def walk(tree, specs) -> int:
        total = 0
        for k, v in tree.items():
            if isinstance(v, dict):
                total += walk(v, specs[k])
            elif isinstance(v, QTensor):
                total += v.q.numel() * v.q.element_size() * pieces(specs[k])
                total += v.scale.numel() * v.scale.element_size() * pieces(scale_spec(specs[k]))
            else:
                total += v.numel() * v.element_size() * pieces(specs[k])
        return total

    return walk(shards[0], specs_for(mesh, _is_moe(shards[0])))


def unshard_kv(parts: list[torch.Tensor]) -> torch.Tensor:
    """The tp slices of a KV tensor ``[..., KV/tp, hd]`` (in tp order) as
    the unsharded ``[..., KV, hd]``; pinned host slices give a pinned
    whole (a later copy to the card from it does not wait)."""
    if len(parts) == 1:
        return parts[0]
    first = parts[0]
    pin = first.device.type == "cpu" and first.is_pinned()
    shape = (*first.shape[:-2], sum(p.shape[-2] for p in parts), first.shape[-1])
    return torch.cat(parts, dim=-2, out=torch.empty(shape, dtype=first.dtype, pin_memory=pin))



def unshard_slots(parts: list[torch.Tensor]) -> torch.Tensor:
    """The sp slices of a KV prefix ``[L, n_j, KV, hd]`` (in sp order) as
    the unsharded ``[L, n, KV, hd]``: joined along the slot axis, the empty
    slices (shards past the prefix) dropped; a lone slice is returned
    itself (a view of its arena)."""
    live = [p for p in parts if p.shape[1]] or parts[:1]
    return live[0] if len(live) == 1 else torch.cat(live, dim=1)


def unshard_layers(parts: list[torch.Tensor]) -> torch.Tensor:
    """The pipeline stages' slices ``[L/pp, ...]`` (in stage order) as the
    unsharded ``[L, ...]``."""
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
