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

Training (``train.py`` over a mesh) cuts the tree with ``shard_train_params``
instead: one leaf per distinct slice for the optimizer, its gradient summed
over the shards that hold it exactly once, and every copy on another device
given the same update (``TrainShards``); ``unshard_params`` joins a cut
tree back into one; ``batch_spec``/``shard_batch`` place tokens over dp
and sp.
"""

from __future__ import annotations

from typing import NamedTuple

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


def pipeline_layer_specs(moe: bool, tp: bool = False) -> dict:
    """The ``layers`` subtree with its leading layer axis over pp: each stage
    holds its ``L/pp`` layers whole, or with ``tp`` (a training pipeline
    over dp × tp × pp) its tp slice of their widths, as ``param_specs``
    cuts them; an expert axis is never split (pp does not compose with
    ep)."""
    return {
        k: ("pp", *(a if tp and a == "tp" else None for a in v[1:]))
        for k, v in param_specs(moe)["layers"].items()
    }


def pipeline_param_specs(moe: bool, tp: bool = False) -> dict:
    """The tree under a pp mesh: layers staged; ``embed`` rows and
    ``lm_head`` columns vocab-sharded over pp, so no stage replicates the
    two V × D matrices (over tp they replicate)."""
    return {
        "embed": ("pp", None),
        "layers": pipeline_layer_specs(moe, tp=tp),
        "final_norm": (None,),
        "lm_head": (None, "pp"),
    }


def specs_for(mesh: Mesh, moe: bool) -> dict:
    """The spec tree a mesh cuts the params by: the pipeline's on a pp
    mesh (widths over tp within a stage), else the tp × ep one."""
    if mesh.shape["pp"] > 1:
        return pipeline_param_specs(moe, tp=mesh.shape["tp"] > 1)
    return param_specs(moe)


def batch_spec() -> Spec:
    """Tokens and positions ``[B, T]``: batch over dp, sequence over sp."""
    return ("dp", "sp")


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


def _narrowed(x: torch.Tensor, spec: Spec, mesh: Mesh, shard: int) -> torch.Tensor:
    """Shard ``shard``'s slice of ``x`` under ``spec``: a view of ``x``."""
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
    return x


def shard_tensor(x: torch.Tensor, spec: Spec, mesh: Mesh, shard: int) -> torch.Tensor:
    """Shard ``shard``'s slice of ``x`` under ``spec``, contiguous, on its
    device (``x`` itself where nothing splits and it is already there)."""
    return _narrowed(x, spec, mesh, shard).to(mesh.device_list[shard]).contiguous()


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


def _slice_key(spec: Spec, mesh: Mesh, shard: int) -> tuple:
    """Which slice of a leaf under ``spec`` shard ``shard`` holds: its index
    along each axis the spec splits."""
    return tuple(mesh.index(a, shard) for a in spec if a is not None and mesh.shape[a] > 1)


def replicated_axes(spec: Spec, mesh: Mesh) -> tuple[str, ...]:
    """The mesh axes a leaf under ``spec`` is copied over (the shards along
    them hold the same slice), dp across processes included."""
    return tuple(a for a in mesh.shape if a not in spec and (mesh.shape[a] > 1 or (a == "dp" and mesh.hosts > 1)))


class TrainShards(NamedTuple):
    """A param tree cut for training over a mesh.

    - ``trees``: one params tree per shard, what ``models/llama.forward``
      takes over the mesh;
    - ``leaves``: each distinct slice of every leaf once, on the device of
      the first shard that holds it: the optimizer's leaves (its AdamW
      moments are then cut like them);
    - ``copies[i]``: the other tensors that hold ``leaves[i]``'s slice
      (each once), and ``axes[i]`` the mesh axes it is copied over;
    - ``specs``: the spec tree of the cut.

    With ``share`` the shards of one slice on one device hold one tensor,
    so autograd sums their gradients itself; a shard on another device
    holds a copy, a leaf of its own, whose gradient ``reduce_grads`` adds
    to the slice's once and which ``copy_to_replicas`` refreshes after the
    update."""

    trees: list[dict]
    leaves: list[torch.Tensor]
    copies: list[list[torch.Tensor]]
    axes: list[tuple[str, ...]]
    specs: dict


def shard_train_params(params: dict, mesh: Mesh, moe: bool | None = None, share: bool = True,
                       dtype: torch.dtype | None = None) -> TrainShards:
    """Cut a dense params tree for training (``TrainShards``): each distinct
    slice a fresh tensor that requires grad (never a view of ``params``), in
    ``dtype`` (the leaf's by default). ``share=False`` gives every shard a
    copy of its own even where shards share a device, as shards on separate
    cards hold them."""
    specs = specs_for(mesh, _is_moe(params) if moe is None else moe)
    trees: list[dict] = [{} for _ in range(mesh.size)]
    out_leaves, copies, axes = [], [], []

    def cut(tree, spec_tree, outs):
        for k, v in tree.items():
            if isinstance(v, dict):
                subs = [o.setdefault(k, {}) for o in outs]
                cut(v, spec_tree[k], subs)
                continue
            spec = spec_tree[k]
            held: dict[tuple, tuple[int, dict]] = {}  # slice → (its leaf's index, {device: tensor})
            for s in range(mesh.size):
                dev = mesh.device_list[s]
                key = _slice_key(spec, mesh, s)
                if key not in held:
                    piece = _narrowed(v.detach(), spec, mesh, s)
                    t = torch.empty(piece.shape, dtype=dtype or piece.dtype, device=dev).copy_(piece).requires_grad_()
                    held[key] = (len(out_leaves), {dev: t})
                    out_leaves.append(t)
                    copies.append([])
                    axes.append(replicated_axes(spec, mesh))
                else:
                    index, on = held[key]
                    t = on.get(dev) if share else None
                    if t is None:
                        t = out_leaves[index].detach().to(dev, copy=True).requires_grad_()
                        on.setdefault(dev, t)
                        copies[index].append(t)
                outs[s][k] = t

    cut(params, specs, trees)
    return TrainShards(trees, out_leaves, copies, axes, specs)


def unshard_tensor(parts: list[torch.Tensor], spec: Spec, mesh: Mesh, device=None) -> torch.Tensor:
    """The whole tensor from every shard's slice of it under ``spec`` (the
    slices joined by ``torch.cat``, so autograd flows back to each), on
    ``device`` (shard 0's by default)."""
    split = [(dim, a) for dim, a in enumerate(spec) if a is not None and mesh.shape[a] > 1]
    dev = device or parts[0].device

    def build(fixed: dict, k: int) -> torch.Tensor:
        if k == len(split):
            s = next(s for s in range(mesh.size) if all(mesh.index(a, s) == i for a, i in fixed.items()))
            return parts[s].to(dev)
        dim, a = split[k]
        return torch.cat([build({**fixed, a: i}, k + 1) for i in range(mesh.shape[a])], dim=dim)

    return build({}, 0)


def unshard_params(trees: list[dict], mesh: Mesh, specs: dict | None = None, device=None) -> dict:
    """The inverse of a cut: the whole tree from the shards' trees, on
    ``device`` (shard 0's by default); for tests and checkpoints."""
    specs = specs_for(mesh, _is_moe(trees[0])) if specs is None else specs

    def walk(nodes, spec_tree):
        return {
            k: walk([n[k] for n in nodes], spec_tree[k]) if isinstance(v, dict)
            else unshard_tensor([n[k].detach() for n in nodes], spec_tree[k], mesh, device)
            for k, v in nodes[0].items()
        }

    return walk(trees, specs)


def shard_batch(x: torch.Tensor, mesh: Mesh, spec: Spec | None = None) -> list[torch.Tensor]:
    """One slice of ``x`` per shard under ``spec`` (``batch_spec()`` by
    default), each on its shard's device."""
    spec = batch_spec() if spec is None else spec
    return [shard_tensor(x, spec + (None,) * (x.dim() - len(spec)), mesh, s) for s in range(mesh.size)]


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
