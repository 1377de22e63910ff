"""Device mesh construction.

Reference: ``agentainer_tpu/parallel/mesh.py`` — ``make_mesh``, ``pick_tp``
and ``pick_ep``. A mesh has the reference's named axes

    dp  — data parallel (replica fan-out)
    tp  — tensor parallel (attention heads / FFN width)
    sp  — sequence parallel
    ep  — expert parallel (MoE experts)
    pp  — pipeline parallel (layer stages)

and the reference's device order. It is a plain object over a list of
``torch.device``s rather than a ``jax.sharding.Mesh``: a shard is one entry
of the flattened ``(dp, tp, sp, ep, pp)`` grid, and a device may repeat,
which is how the CPU and a one-card machine hold a mesh (``LLMEngine.create``
itself never repeats a card).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.configs import ModelConfig

AXES = ("dp", "tp", "sp", "ep", "pp")


class Mesh:
    """``devices``: an object array ``[dp, tp, sp, ep, pp]`` of
    ``torch.device``. Shard ``s`` is the ``s``-th entry of that grid in
    row-major order; ``coords[s]`` is its index along every axis. ``hosts``:
    the processes dp spans (1; ``parallel/dcn.host_mesh`` sets it), each
    holding such a grid of its own devices."""

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.hosts = 1
        self.shape = dict(zip(AXES, devices.shape))
        self.size = int(devices.size)
        self.device_list: list[torch.device] = list(devices.reshape(-1))
        self.coords: list[tuple[int, ...]] = [tuple(int(i) for i in c) for c in np.ndindex(devices.shape)]

    def index(self, axis: str, shard: int) -> int:
        """Shard ``shard``'s position along ``axis``."""
        return self.coords[shard][AXES.index(axis)]

    def groups(self, axes: tuple[str, ...]) -> list[list[int]]:
        """The shards that differ only along ``axes``, one list per group
        (in shard order): a collective over ``axes`` runs within each."""
        keep = [i for i, a in enumerate(AXES) if a not in axes]
        out: dict[tuple, list[int]] = {}
        for s, c in enumerate(self.coords):
            out.setdefault(tuple(c[i] for i in keep), []).append(s)
        return list(out.values())

    def first_of(self, axes: tuple[str, ...]) -> list[int]:
        """One shard per position along ``axes``, the others at 0 (the
        shards holding distinct slices of what splits over ``axes``), in
        order of that position."""
        zero = [i for i, a in enumerate(AXES) if a not in axes]
        return [s for s, c in enumerate(self.coords) if all(c[i] == 0 for i in zero)]

    @property
    def distinct_devices(self) -> list[torch.device]:
        return list(dict.fromkeys(self.device_list))

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        hosts = f" x {self.hosts} hosts" if self.hosts > 1 else ""
        return f"Mesh({dims}{hosts}; {[str(d) for d in self.device_list]})"


def make_mesh(
    n_devices: int | None = None,
    tp: int = 1,
    sp: int = 1,
    ep: int = 1,
    pp: int = 1,
    devices: list | None = None,
) -> Mesh:
    """Mesh with axes (dp, tp, sp, ep, pp); dp absorbs the remaining
    devices. pp is last so pipeline stages are the widest strides, as in
    the reference. ``devices`` defaults to the visible cards, the first
    ``n_devices`` of them (all without it); fewer than that raises, as no
    card does. A mesh on the CPU, or with shards sharing a card, is asked
    for by name (``devices=["cpu"] * n``, ``["cuda:0"] * n``)."""
    if devices is None:
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = visible if n_devices is None else n_devices
        if n < 1 or n > visible:
            raise ValueError(
                f"a mesh of {n_devices if n_devices is not None else 'the visible'} cards asked for, "
                f"{visible} visible; pass devices= for a mesh on the CPU or on a shared card"
            )
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(f"{n_devices} devices asked for, {len(devs)} given")
        devs = devs[:n_devices]
    n = len(devs)
    denom = tp * sp * ep * pp
    if n % denom != 0:
        raise ValueError(f"{n} devices not divisible by tp*sp*ep*pp={denom}")
    dp = n // denom
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(dp, pp, tp, sp, ep).transpose(0, 2, 3, 4, 1))


def pick_tp(cfg: ModelConfig, n_devices: int) -> int:
    """Largest tp that divides both the device count and the model's KV-head
    count (GQA shards KV heads; tp beyond n_kv_heads would split a head)."""
    tp = 1
    for cand in range(1, n_devices + 1):
        if n_devices % cand == 0 and cfg.n_kv_heads % cand == 0 and cfg.n_heads % cand == 0:
            tp = cand
    return tp


def pick_ep(cfg: ModelConfig, n_devices: int) -> int:
    """Largest ep ≤ n_devices that evenly shards the expert set — each
    device owns E/ep experts' weights whole (the expert axis never splits
    one expert's matrices)."""
    if not cfg.is_moe:
        return 1
    ep = 1
    for cand in range(1, max(1, n_devices) + 1):
        if cfg.n_experts % cand == 0:
            ep = cand
    return ep
