"""Fleet routing tier — replica choice for the proxy's dispatch path.

One agent, N engine replicas (config ``fleet.replicas`` / per-deploy
``replicas``): the router decides which replica serves each dispatch.

Policy, in order:

- **health-aware exclusion** — replicas the monitor marked SUSPECT/DEAD
  and replicas whose per-replica circuit breaker is open are not
  candidates (one bad replica must never take the agent down with it);
- **session affinity** — a session whose KV pages are resident on a
  replica keeps routing there (prefill-from-scratch is the expensive
  path; under the paged arena residency is cheap to honor). Affinity is
  in-memory soft state: it is rebuilt by observation, never persisted —
  losing it costs one snapshot restore, not correctness;
- **failover (handoff)** — when the affine replica is dead/excluded the
  session re-pins to a survivor. The survivor restores the session from
  its store-durable KV snapshot (SNAP_VERSION 3) + journaled fed stream,
  so decode resumes token-identically;
- **power-of-two-choices** — fresh sessions sample two candidates with a
  seeded RNG and take the less occupied one: near-best load spread at
  O(1) cost. Occupancy is the ENGINE-reported queue+waiting+active depth
  (fed by the replica monitor's probe loop) when a sample exists, else
  the proxy-side in-flight count — the engine's own view also counts
  replayed journal work, other proxies, and lanes still decoding after
  their HTTP response settled, which the proxy count cannot see.

Failpoints model STALE ROUTING STATE, the fleet's characteristic failure:
``router.pick`` firing returns a dead/excluded replica when one exists
(a routing table that hasn't caught up with a death), ``replica.handoff``
firing keeps a session pinned to its dead replica for one more dispatch.
Both are recovered by the proxy's bounded retry-on-next-replica — the
journal CAS admits exactly one dispatcher, so the retry cannot
double-execute.

The router only engages for agents with more than one replica;
``fleet.replicas = 1`` deployments never construct a choice here beyond
the primary endpoint, keeping the single-engine behavior bit-identical.

Reference: ``agentainer_tpu/server/router.py`` — an own copy, standard
library only (the daemon's import graph holds no torch).
"""

from __future__ import annotations

import collections
import random
import threading
from dataclasses import dataclass

from .. import faults
from ..core.resilience import KeyedBreakers
from ..core.spec import Agent

# per-replica health states, fed by the replica monitor (manager/health.py)
REPLICA_ALIVE = "alive"
REPLICA_SUSPECT = "suspect"
REPLICA_DEAD = "dead"


@dataclass
class ReplicaChoice:
    engine_id: str
    endpoint: str


class ReplicaRouter:
    def __init__(self, manager, fleet_cfg=None, seed: int = 0):
        self.manager = manager
        self.retry_next_replica = int(
            getattr(fleet_cfg, "retry_next_replica", 2) if fleet_cfg else 2
        )
        self.breakers = KeyedBreakers(
            failure_threshold=int(
                getattr(fleet_cfg, "breaker_failures", 3) if fleet_cfg else 3
            ),
            cooldown_s=float(
                getattr(fleet_cfg, "breaker_cooldown_s", 2.0) if fleet_cfg else 2.0
            ),
        )
        # seeded: the p2c sample sequence is deterministic for a given seed;
        # there is no adversary to be unpredictable against
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        # (agent_id, session) -> engine_id; soft state (see module doc).
        # LRU-bounded: session ids are client-supplied, so an unbounded map
        # would grow one entry per session forever — evicting an old pin
        # costs at most one snapshot restore on that session's next turn.
        self._affinity: "collections.OrderedDict[tuple[str, str], str]" = (
            collections.OrderedDict()
        )
        self._affinity_cap = 8192
        self._inflight: dict[str, int] = {}
        # engine-REPORTED occupancy (queue depth + waiting + active lanes),
        # fed by the replica monitor from each probe's metrics sample. When
        # present it supersedes the proxy-side in-flight count for p2c: the
        # proxy only sees its own dispatches, while the engine's own queue
        # view also counts work from journal replays, other proxies, and
        # lanes still decoding after the HTTP response settled.
        self._load: dict[str, int] = {}
        self._health: dict[str, str] = {}
        self.picks_total = 0
        self.handoffs_total = 0
        self.handoffs_failed_total = 0
        self.stale_picks_total = 0

    # -- health plane feed -------------------------------------------------
    def set_health(self, engine_id: str, state: str) -> None:
        with self._lock:
            self._health[engine_id] = state

    def health_of(self, engine_id: str) -> str:
        return self._health.get(engine_id, REPLICA_ALIVE)

    def set_load(self, engine_id: str, depth: int) -> None:
        """Record engine-reported occupancy for p2c (see ``_load``).
        Negative clamps to zero so a junk sample can't make a replica
        look infinitely attractive."""
        with self._lock:
            self._load[engine_id] = max(0, int(depth))

    def _occupancy(self, engine_id: str) -> int:
        """p2c load signal: engine-reported when the monitor has fed a
        sample, else the proxy-side in-flight count (single-node deploys
        and the window before the first probe)."""
        load = self._load.get(engine_id)
        if load is not None:
            return load
        return self._inflight.get(engine_id, 0)

    def on_replica_dead(self, agent_id: str, engine_id: str) -> None:
        """Fleet repair observed a replica death: exclude it and drop every
        session pinned to it so their next dispatch hands off immediately
        instead of burning a retry against a corpse."""
        with self._lock:
            self._health[engine_id] = REPLICA_DEAD
            doomed = [
                k
                for k, eid in self._affinity.items()
                if eid == engine_id and k[0] == agent_id
            ]
            for k in doomed:
                del self._affinity[k]

    def forget(self, engine_id: str) -> None:
        """A replica was replaced/removed: drop its breaker and health so a
        respawn (fresh engine id) starts clean and stale ids don't leak."""
        self.breakers.drop(engine_id)
        with self._lock:
            self._health.pop(engine_id, None)
            self._inflight.pop(engine_id, None)
            self._load.pop(engine_id, None)
            for k in [k for k, eid in self._affinity.items() if eid == engine_id]:
                del self._affinity[k]

    # -- dispatch accounting ----------------------------------------------
    def begin(self, engine_id: str) -> None:
        with self._lock:
            self._inflight[engine_id] = self._inflight.get(engine_id, 0) + 1

    def end(self, engine_id: str, ok: bool) -> None:
        with self._lock:
            n = self._inflight.get(engine_id, 0)
            if n <= 1:
                self._inflight.pop(engine_id, None)
            else:
                self._inflight[engine_id] = n - 1
        br = self.breakers.get(engine_id)
        if ok:
            br.ok()
        else:
            br.fail()

    def _usable(self, engine_id: str) -> bool:
        if self._health.get(engine_id, REPLICA_ALIVE) != REPLICA_ALIVE:
            return False
        # read-only breaker check: allow() would consume the half-open
        # probe slot; the state string is enough to exclude an open breaker
        # while letting half-open replicas take live traffic as the probe
        return self.breakers.get(engine_id).state != "open"

    # -- the pick ----------------------------------------------------------
    def pick(
        self, agent: Agent, session: str = "", exclude: tuple | frozenset = ()
    ) -> ReplicaChoice | None:
        """Choose the replica for one dispatch, or None when every replica
        is excluded. ``exclude`` carries the engine ids this dispatch
        already failed against (the bounded retry's memory)."""
        candidates = self.manager.replica_endpoints(agent)
        if not candidates:
            return None
        by_id = dict(candidates)
        with self._lock:
            self.picks_total += 1
            usable = [
                (eid, ep)
                for eid, ep in candidates
                if eid not in exclude and self._usable(eid)
            ]
            # failpoint: a firing router.pick models a stale routing table —
            # hand back a dead/excluded replica when one exists, so the
            # dispatch path's crash heuristic + bounded retry must absorb it
            try:
                faults.fire("router.pick")
            except Exception:
                stale = [
                    (eid, ep)
                    for eid, ep in candidates
                    if eid not in exclude and not self._usable(eid)
                ]
                if stale:
                    self.stale_picks_total += 1
                    return ReplicaChoice(*stale[0])
            if not usable:
                # every replica excluded/unhealthy: the dispatch attempt is
                # the real probe — fall back to anything not yet tried
                # rather than refusing outright (a wrongly-SUSPECT replica
                # still serving is better than a guaranteed 502)
                usable = [(eid, ep) for eid, ep in candidates if eid not in exclude]
                if not usable:
                    return None
            key = (agent.id, session)
            if session:
                aff = self._affinity.get(key)
                if aff is not None:
                    self._affinity.move_to_end(key)  # LRU touch
                    if any(eid == aff for eid, _ in usable):
                        return ReplicaChoice(aff, by_id[aff])
                    # affine replica dead/excluded: HANDOFF to a survivor.
                    # A firing replica.handoff failpoint keeps the stale
                    # pin for one more dispatch (the retry loop recovers).
                    try:
                        faults.fire("replica.handoff")
                    except Exception:
                        self.handoffs_failed_total += 1
                        if aff in by_id and aff not in exclude:
                            return ReplicaChoice(aff, by_id[aff])
                    self.handoffs_total += 1
            if len(usable) == 1:
                choice = usable[0]
            else:
                a, b = self._rng.sample(usable, 2)
                ia = self._occupancy(a[0])
                ib = self._occupancy(b[0])
                choice = a if ia <= ib else b
            if session:
                self._affinity[key] = choice[0]
                self._affinity.move_to_end(key)
                while len(self._affinity) > self._affinity_cap:
                    self._affinity.popitem(last=False)
            return ReplicaChoice(*choice)

    # -- observability -----------------------------------------------------
    def stats(self, agent: Agent | None = None) -> dict:
        """Per-replica routing/breaker state for the metrics surface."""
        breakers = self.breakers.stats()
        with self._lock:
            inflight = dict(self._inflight)
            load = dict(self._load)
            health = dict(self._health)
            affinity_count: dict[str, int] = {}
            for (_aid, _sess), eid in self._affinity.items():
                affinity_count[eid] = affinity_count.get(eid, 0) + 1
            totals = {
                "picks_total": self.picks_total,
                "handoffs_total": self.handoffs_total,
                "handoffs_failed_total": self.handoffs_failed_total,
                "stale_picks_total": self.stale_picks_total,
            }
        ids = None
        if agent is not None:
            ids = set(agent.all_engine_ids())
        replicas = {}
        for eid in ids if ids is not None else set(health) | set(breakers) | set(inflight):
            replicas[eid] = {
                "health": health.get(eid, REPLICA_ALIVE),
                "inflight": inflight.get(eid, 0),
                "load": load.get(eid),
                "sessions": affinity_count.get(eid, 0),
                "breaker": breakers.get(eid)
                or {"state": "closed", "consecutive_failures": 0},
            }
        return {"replicas": replicas, **totals}
