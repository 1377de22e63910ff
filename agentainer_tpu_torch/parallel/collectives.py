"""The only places the shards of a mesh meet (no reference counterpart:
GSPMD inserts the reference's collectives from its sharding annotations,
and ``ppermute`` the pipeline's).

``all_reduce`` sums each group's partials on the group's first shard's
device, in float32, and hands every shard of the group the sum in the
partials' dtype; ``all_gather`` concatenates each group's slices there and
hands every shard the whole; ``handoff`` moves one pipeline stage's
activation to the next stage's device, and ``broadcast`` one shard's
tensor to every shard of the mesh. On one device the copies are no-ops
(every shard of a group gets the same tensor); across cards they are peer
copies. One code path serves both.

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


def all_reduce(parts: list[torch.Tensor], mesh: Mesh, axes) -> list[torch.Tensor]:
    """``parts[s]`` is shard ``s``'s partial; every shard gets the sum of
    its group's (the shards that differ only along ``axes``)."""
    axes = _axes(axes)
    if all(mesh.shape[a] == 1 for a in axes):
        return list(parts)
    _note("all_reduce", axes, parts[0].numel())
    out = list(parts)
    for group in mesh.groups(axes):
        dev = parts[group[0]].device
        acc = parts[group[0]].float()
        for s in group[1:]:
            acc = acc + parts[s].to(dev, non_blocking=True).float()
        total = acc.to(parts[group[0]].dtype)
        for s in group:
            out[s] = total.to(mesh.device_list[s], non_blocking=True)
    return out


def all_gather(parts: list[torch.Tensor], mesh: Mesh, axis: str, dim: int) -> list[torch.Tensor]:
    """``parts[s]`` is shard ``s``'s slice along ``dim``; every shard gets
    its group's slices concatenated in ``axis`` order."""
    if mesh.shape[axis] == 1:
        return list(parts)
    _note("all_gather", (axis,), parts[0].numel())
    out = list(parts)
    for group in mesh.groups((axis,)):
        dev = parts[group[0]].device
        ordered = sorted(group, key=lambda s: mesh.index(axis, s))
        whole = torch.cat([parts[s].to(dev, non_blocking=True) for s in ordered], dim=dim)
        for s in group:
            out[s] = whole.to(mesh.device_list[s], non_blocking=True)
    return out


def handoff(x: torch.Tensor, mesh: Mesh, dst: int) -> torch.Tensor:
    """A pipeline stage's activation ``x`` on shard ``dst``'s device: the hop
    to the next stage (the reference's ``ppermute`` over pp)."""
    _note("handoff", ("pp",), x.numel())
    return x.to(mesh.device_list[dst], non_blocking=True)


def broadcast(x: torch.Tensor, mesh: Mesh, axes) -> list[torch.Tensor]:
    """One shard's ``x`` on every shard's device (the reference's masked
    psum off the last pipeline stage); the mesh is one group over
    ``axes``."""
    axes = _axes(axes)
    if all(mesh.shape[a] == 1 for a in axes):
        return [x] * mesh.size
    _note("broadcast", axes, x.numel())
    return [x.to(d, non_blocking=True) for d in mesh.device_list]
