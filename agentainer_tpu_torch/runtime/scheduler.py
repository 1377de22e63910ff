"""Slice scheduler — GPU/memory placement for agents.

Reference: ``agentainer_tpu/runtime/scheduler.py`` — the same first-fit
placement with per-chip memory accounting, where each weight-sharing group
(agents serving one model config) counts its weights once, persisted at
``slices:allocations`` so a restarted control plane reconciles placement
instead of double-booking. What differs is the topology: a "chip" is one
GPU of the machine (``config.SliceConfig``: the count and per-card memory
that ``nvidia-smi`` reports), and the cards of one host are joined all to
all (NVLink), so any run of card ids is a placement window; the
reference's 2-D ICI grid of sub-rectangles has no counterpart.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from ..config import DEFAULT_GPU_MEMORY
from ..core.errors import ResourceExhausted
from ..core.spec import Agent
from ..store.base import Store
from ..store.schema import Keys


@dataclass
class Placement:
    agent_id: str
    chips: tuple[int, ...]
    hbm_bytes: int
    share_group: str = ""  # e.g. model config name when weights are shared

    def to_dict(self) -> dict:
        return {
            "agent_id": self.agent_id,
            "chips": list(self.chips),
            "hbm_bytes": self.hbm_bytes,
            "share_group": self.share_group,
        }

    @staticmethod
    def from_dict(d: dict) -> "Placement":
        return Placement(
            agent_id=d["agent_id"],
            chips=tuple(d["chips"]),
            hbm_bytes=int(d["hbm_bytes"]),
            share_group=d.get("share_group", ""),
        )


@dataclass
class SliceTopology:
    """The machine's GPUs: ``total_chips`` cards of ``hbm_per_chip`` bytes
    each, ``hosts`` hosts owning contiguous id runs."""

    total_chips: int = 1
    hbm_per_chip: int = DEFAULT_GPU_MEMORY
    name: str = "gpu-1"
    hosts: int = 1

    def __post_init__(self) -> None:
        if self.total_chips < 0:
            raise ValueError(f"total_chips={self.total_chips} must be >= 0")
        if self.hosts < 1 or self.total_chips % self.hosts:
            raise ValueError(
                f"hosts={self.hosts} must divide total_chips={self.total_chips}"
            )

    @property
    def chips_per_host(self) -> int:
        return max(1, self.total_chips // self.hosts)

    def host_of(self, chip: int) -> int:
        return chip // self.chips_per_host

    def spans_hosts(self, chips: tuple[int, ...]) -> bool:
        return len({self.host_of(c) for c in chips}) > 1

    def windows(self, n: int) -> list[tuple[int, ...]]:
        """Candidate card sets of size n, preference-ordered: runs of
        consecutive ids, those inside one host first."""
        out = [tuple(range(s, s + n)) for s in range(self.total_chips - n + 1)]
        if self.hosts > 1:
            out.sort(key=self.spans_hosts)
        return out


class SliceScheduler:
    """First-fit GPU allocator with per-card memory accounting."""

    def __init__(self, store: Store, topology: SliceTopology | None = None):
        self._store = store
        self.topology = topology or SliceTopology()
        self._lock = threading.RLock()
        self._placements: dict[str, Placement] = {}
        self._load()

    # -- persistence -----------------------------------------------------
    def _load(self) -> None:
        raw = self._store.get_json(Keys.SLICE_ALLOCATIONS)
        if raw:
            self._placements = {p["agent_id"]: Placement.from_dict(p) for p in raw}

    def _save(self) -> None:
        self._store.set_json(
            Keys.SLICE_ALLOCATIONS, [p.to_dict() for p in self._placements.values()]
        )

    # -- accounting ------------------------------------------------------
    def _chip_usage(self) -> dict[int, int]:
        """HBM bytes claimed per chip, counting each share group's weights once.

        Within a share group, every member ships the same weights, so the
        group's HBM claim per chip is max(member claims), not the sum.
        """
        by_group: dict[str, list[Placement]] = {}
        solo: list[Placement] = []
        for p in self._placements.values():
            if p.share_group:
                by_group.setdefault(p.share_group, []).append(p)
            else:
                solo.append(p)
        usage: dict[int, int] = {c: 0 for c in range(self.topology.total_chips)}
        for p in solo:
            per_chip = p.hbm_bytes // max(1, len(p.chips))
            for c in p.chips:
                usage[c] += per_chip
        for group in by_group.values():
            chips: set[int] = set()
            for p in group:
                chips.update(p.chips)
            per_chip = max(p.hbm_bytes // max(1, len(p.chips)) for p in group)
            for c in chips:
                usage[c] += per_chip
        return usage

    # -- API -------------------------------------------------------------
    def allocate(self, agent: Agent, share_group: str = "") -> Placement:
        with self._lock:
            if agent.id in self._placements:
                return self._placements[agent.id]
            n = max(1, agent.resources.chips)
            if n > self.topology.total_chips:
                raise ResourceExhausted(
                    f"requested {n} GPUs but slice {self.topology.name} has "
                    f"{self.topology.total_chips}"
                )
            need_per_chip = agent.resources.hbm_bytes // n
            usage = self._chip_usage()

            # Weight sharing: prefer the chips the share group already owns —
            # but only if raising the group's per-chip claim still fits
            # (usage already counts the group at its current max).
            if share_group:
                members = [p for p in self._placements.values() if p.share_group == share_group]
                group_chips = sorted({c for p in members for c in p.chips})
                if len(group_chips) >= n:
                    chips = tuple(group_chips[:n])
                    current_claim = max(
                        (p.hbm_bytes // max(1, len(p.chips)) for p in members), default=0
                    )
                    delta = max(0, need_per_chip - current_claim)
                    if all(usage[c] + delta <= self.topology.hbm_per_chip for c in chips):
                        placement = Placement(
                            agent.id, chips, agent.resources.hbm_bytes, share_group
                        )
                        self._placements[agent.id] = placement
                        self._save()
                        return placement
                    # group chips can't absorb the larger claim: place solo
                    # (weights not shared rather than silently overcommitted)
                    share_group = ""

            # first fit over runs of card ids (SliceTopology.windows)
            for window in self.topology.windows(n):
                if all(usage[c] + need_per_chip <= self.topology.hbm_per_chip for c in window):
                    placement = Placement(agent.id, window, agent.resources.hbm_bytes, share_group)
                    self._placements[agent.id] = placement
                    self._save()
                    return placement
            raise ResourceExhausted(
                f"no run of {n} GPUs with {need_per_chip} B free memory per GPU "
                f"on {self.topology.name}"
            )

    def release(self, agent_id: str) -> None:
        with self._lock:
            if self._placements.pop(agent_id, None) is not None:
                self._save()

    def placement(self, agent_id: str) -> Placement | None:
        with self._lock:
            return self._placements.get(agent_id)

    def placements(self) -> list[Placement]:
        with self._lock:
            return list(self._placements.values())

    def free_hbm(self) -> dict[int, int]:
        with self._lock:
            usage = self._chip_usage()
            return {c: self.topology.hbm_per_chip - u for c, u in usage.items()}
