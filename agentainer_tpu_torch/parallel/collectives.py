"""The only places the shards of a mesh meet (no reference counterpart:
GSPMD inserts the reference's collectives from its sharding annotations,
and ``ppermute``/``all_to_all`` the ring's, Ulysses' and the pipeline's).

``all_reduce`` sums each group's partials on the group's first shard's
device, in float32, and hands every shard of the group the sum in the
partials' dtype; ``all_gather`` concatenates each group's slices there and
hands every shard the whole; ``all_to_all`` cuts each shard's tensor into
one tile per group member and hands member ``i`` the ``i``-th tiles,
joined in the members' order (the reference's ``lax.all_to_all(...,
tiled=True)``); ``ring_shift`` hands each shard its predecessor's tensor
along one axis (the reference's ``ppermute`` ``j -> j + 1``);
``handoff`` moves one pipeline stage's activation to the next stage's
device, and ``broadcast`` one shard's tensor to every shard of its group.
On one device the copies are no-ops (every shard of a group gets the same
tensor); across cards they are peer copies. One code path serves both.
Every one of them is built of ``.to``, ``.float``, ``narrow`` and
``torch.cat``, so autograd flows through them: the gradient of a loss
through a collective is the unsharded gradient.

``parts[i]`` belongs to shard ``i`` of the mesh, or with ``shards`` to
shard ``shards[i]`` (a pipeline stage's shards: the others take no part).
A mesh built by ``parallel/dcn.host_mesh`` spans processes along dp
(``mesh.hosts`` > 1): an ``all_reduce`` over dp then also sums across the
processes with ``torch.distributed`` (gloo for CPU tensors, NCCL for CUDA
ones; ``_ProcessSum``), and ``reduce_grads`` sums the gradients of the
leaves dp copies across them.

Each call appends its kind, its axes and the elements of one shard's
operand to the active ``record()`` log, which the collective contracts of
``analysis/contracts.py`` read (the port's counterpart of the reference's
compiled-HLO checks).
"""

from __future__ import annotations

import contextlib

import torch

from .mesh import Mesh

_logs: list[list[dict]] = []


@contextlib.contextmanager
def record():
    """Collect the collectives called inside the block: a list of
    ``{"kind", "axes", "elements"}``."""
    log: list[dict] = []
    _logs.append(log)
    try:
        yield log
    finally:
        _logs.remove(log)


def _note(kind: str, axes: tuple[str, ...], elements: int) -> None:
    for log in _logs:
        log.append({"kind": kind, "axes": axes, "elements": elements})


def _axes(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _groups(mesh: Mesh, axes: tuple[str, ...], shards) -> list[list[tuple[int, int]]]:
    """The groups over ``axes`` among the shards that take part, each a list
    of (position in ``parts``, shard) in shard order."""
    at = {s: i for i, s in enumerate(range(mesh.size) if shards is None else shards)}
    groups = [[(at[s], s) for s in g if s in at] for g in mesh.groups(axes)]
    return [g for g in groups if g]


class _ProcessSum(torch.autograd.Function):
    """The sum over the processes of a multi-host mesh (``torch.distributed``'s
    default group: gloo for a CPU tensor, NCCL for a CUDA one). Its
    backward passes the gradient through unchanged: each process
    differentiates its own part, and the gradients of the leaves copied
    over dp are summed across the processes after the backward
    (``reduce_grads``), which is the sum's gradient counted once."""

    @staticmethod
    def forward(ctx, x):
        import torch.distributed as dist

        out = x.detach().clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        return g


def all_reduce(parts: list[torch.Tensor], mesh: Mesh, axes, shards=None) -> list[torch.Tensor]:
    """``parts[i]`` is shard ``i``'s partial (``shards[i]``'s); every shard
    gets the sum of its group's (the shards that differ only along
    ``axes``), and over dp on a mesh across processes their sum too."""
    axes = _axes(axes)
    hosts = mesh.hosts if "dp" in axes else 1
    if hosts == 1 and all(mesh.shape[a] == 1 for a in axes):
        return list(parts)
    _note("all_reduce", axes, parts[0].numel())
    out = list(parts)
    for group in _groups(mesh, axes, shards):
        (i0, _), rest = group[0], group[1:]
        dev = parts[i0].device
        acc = parts[i0].float()
        for i, _ in rest:
            acc = acc + parts[i].to(dev, non_blocking=True).float()
        if hosts > 1:
            acc = _ProcessSum.apply(acc)
        total = acc.to(parts[i0].dtype)
        for i, s in group:
            out[i] = total.to(mesh.device_list[s], non_blocking=True)
    return out


def all_gather(parts: list[torch.Tensor], mesh: Mesh, axis: str, dim: int, shards=None) -> list[torch.Tensor]:
    """``parts[i]`` is shard ``i``'s slice along ``dim``; every shard gets
    its group's slices concatenated in ``axis`` order."""
    if mesh.shape[axis] == 1:
        return list(parts)
    _note("all_gather", (axis,), parts[0].numel())
    out = list(parts)
    for group in _groups(mesh, (axis,), shards):
        dev = parts[group[0][0]].device
        ordered = sorted(group, key=lambda m: mesh.index(axis, m[1]))
        whole = torch.cat([parts[i].to(dev, non_blocking=True) for i, _ in ordered], dim=dim)
        for i, s in group:
            out[i] = whole.to(mesh.device_list[s], non_blocking=True)
    return out


def all_to_all(parts: list[torch.Tensor], mesh: Mesh, axis: str, split_dim: int, concat_dim: int,
               shards=None) -> list[torch.Tensor]:
    """Within each group over ``axis`` (``n`` members in ``axis`` order):
    member ``i`` gets tile ``i`` of every member's ``split_dim`` (cut in
    ``n`` equal tiles), joined along ``concat_dim`` in the members' order."""
    n = mesh.shape[axis]
    if n == 1:
        return list(parts)
    if parts[0].shape[split_dim] % n:
        raise ValueError(f"axis {split_dim} of {tuple(parts[0].shape)} does not split over {axis}={n}")
    _note("all_to_all", (axis,), parts[0].numel())
    size = parts[0].shape[split_dim] // n
    out = list(parts)
    for group in _groups(mesh, (axis,), shards):
        ordered = sorted(group, key=lambda m: mesh.index(axis, m[1]))
        for k, (i, s) in enumerate(ordered):
            dev = mesh.device_list[s]
            out[i] = torch.cat(
                [parts[j].narrow(split_dim, k * size, size).to(dev, non_blocking=True) for j, _ in ordered],
                dim=concat_dim,
            )
    return out


def ring_shift(parts: list[torch.Tensor], mesh: Mesh, axis: str, shards=None) -> list[torch.Tensor]:
    """Each shard gets the tensor of its predecessor along ``axis`` (the
    member at ``j`` sends to ``(j + 1) % n``)."""
    n = mesh.shape[axis]
    if n == 1:
        return list(parts)
    _note("ring_shift", (axis,), parts[0].numel())
    out = list(parts)
    for group in _groups(mesh, (axis,), shards):
        ordered = sorted(group, key=lambda m: mesh.index(axis, m[1]))
        for k, (i, s) in enumerate(ordered):
            src = ordered[(k - 1) % n][0]
            out[i] = parts[src].to(mesh.device_list[s], non_blocking=True)
    return out


def handoff(x: torch.Tensor, mesh: Mesh, dst: int) -> torch.Tensor:
    """A pipeline stage's activation ``x`` on shard ``dst``'s device: the hop
    to the next stage (the reference's ``ppermute`` over pp)."""
    _note("handoff", ("pp",), x.numel())
    return x.to(mesh.device_list[dst], non_blocking=True)


def broadcast(parts: list[torch.Tensor], mesh: Mesh, axes, shards: list[int]) -> list[torch.Tensor]:
    """``parts[i]``, held by shard ``shards[i]`` (one shard of each group
    over ``axes``), on every shard of its group (the reference's masked
    psum off the last pipeline stage); a list over every shard of the
    mesh."""
    axes = _axes(axes)
    if all(mesh.shape[a] == 1 for a in axes):
        return list(parts)
    _note("broadcast", axes, parts[0].numel())
    src = {s: i for i, s in enumerate(shards)}
    out: list = [None] * mesh.size
    for group in mesh.groups(axes):
        x = parts[next(src[s] for s in group if s in src)]
        for s in group:
            out[s] = x.to(mesh.device_list[s], non_blocking=True)
    return out


def reduce_grads(tensors: list[torch.Tensor], mesh: Mesh, axes: tuple[str, ...]) -> None:
    """One slice's gradient, over the tensors that hold it (the optimizer's
    leaf first, then each copy on another device once, ``TrainShards``):
    the copies' gradients summed into the leaf's in f32, and over dp on a
    mesh across processes the processes' sums too."""
    hosts = mesh.hosts if "dp" in axes else 1
    if len(tensors) == 1 and hosts == 1:
        return
    lead = tensors[0]
    _note("all_reduce", axes, lead.numel())
    acc = lead.grad.float() if lead.grad is not None else torch.zeros_like(lead, dtype=torch.float32)
    for t in tensors[1:]:
        if t.grad is not None:
            acc = acc + t.grad.to(lead.device, non_blocking=True).float()
    if hosts > 1:
        import torch.distributed as dist

        dist.all_reduce(acc)
    lead.grad = acc.to(lead.dtype)


@torch.no_grad()
def copy_to_replicas(tensors: list[torch.Tensor], mesh: Mesh, axes: tuple[str, ...]) -> None:
    """The optimizer's leaf ``tensors[0]`` after its update, into each of
    its copies."""
    if len(tensors) == 1:
        return
    _note("broadcast", axes, tensors[0].numel())
    for t in tensors[1:]:
        t.copy_(tensors[0], non_blocking=True)
