"""Deterministic fault-injection plane (failpoints) of the port.

Reference: ``agentainer_tpu/faults.py``, copied: the same registry, arming
grammar, ``ERROR_TYPES``, seeded per-failpoint ``random.Random``, fire
budgets, ``fire``/``fire_async``, ``arm``/``disarm`` and ``ATPU_FAULTS``,
so one arming string arms the same failpoints in either package. The port
keeps its own copy (it imports nothing of the JAX package); both registries
are process-global, so arming one does not arm the other.

Named failpoints cut the engine at the reference's seams (``engine.submit``,
``engine.snapshot``, ``engine.prefill``, ``engine.decode_step``,
``engine.fused_decode``, ``engine.page_alloc``, ``engine.kv_demote``,
``engine.kv_promote`` in ``engine/llm.py``, ``engine.stream`` in
``engine/llm_serve.py``) and the control plane at its own (``proxy.dispatch``,
``store.*``, ``store_client.rpc``, ``journal.*``, ``replay.dispatch``,
``health.probe``, ``watcher.respawn``). Each is armed with an error type, an injected
delay, a *seeded* probability and a fire budget, so a fault schedule
replays identically run to run.

1. **Zero overhead when disarmed.** ``fire()`` is one function call and
   one empty-dict truthiness check when nothing is armed.
2. **Deterministic.** Probabilistic failpoints draw from a per-failpoint
   ``random.Random(seed)``: the decision sequence is a function of (seed,
   evaluation order). Fire counts bound total injections exactly.
3. **Explicit arming only.** Nothing fires unless armed by the environment
   (``ATPU_FAULTS=...``) or a caller of :func:`arm`.

Arming grammar::

    name[:key=value[,key=value...]][;name2...]

    ATPU_FAULTS="engine.prefill:error=RuntimeError,count=2;engine.stream:delay_ms=500,error=none"

Keys: ``error`` (exception class name from :data:`ERROR_TYPES`, or
``none`` for delay-only), ``delay_ms``, ``probability`` (0..1, seeded),
``count`` (max fires; -1 unlimited), ``seed``. A bare ``name`` raises
:class:`FaultInjected` on every evaluation.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field


class FaultInjected(RuntimeError):
    """Default injected error: unmistakably synthetic in logs/metrics."""


# Exception classes a failpoint may raise. Restricted on purpose: these are
# the transport/runtime shapes the planes under test actually classify
# (ConnectionError → crash heuristic, TimeoutError → retry accounting, ...).
ERROR_TYPES: dict[str, type[BaseException]] = {
    "FaultInjected": FaultInjected,
    "ConnectionError": ConnectionError,
    "ConnectionRefusedError": ConnectionRefusedError,
    "ConnectionResetError": ConnectionResetError,
    "TimeoutError": TimeoutError,
    "OSError": OSError,
    "IOError": OSError,
    "RuntimeError": RuntimeError,
    "ValueError": ValueError,
}


@dataclass
class Failpoint:
    name: str
    error: str = "FaultInjected"  # "none" → delay-only
    delay_ms: float = 0.0
    probability: float = 1.0
    count: int = -1  # remaining fires; -1 = unlimited; 0 = exhausted (inert)
    seed: int = 0
    fired: int = 0
    evaluated: int = 0
    _rng: random.Random = field(default=None, repr=False)  # type: ignore[assignment]

    def __post_init__(self) -> None:
        if self.error != "none" and self.error not in ERROR_TYPES:
            raise ValueError(
                f"unknown failpoint error type {self.error!r}; "
                f"known: {sorted(ERROR_TYPES)} or 'none'"
            )
        self.probability = min(1.0, max(0.0, float(self.probability)))
        self._rng = random.Random(self.seed)

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "error": self.error,
            "delay_ms": self.delay_ms,
            "probability": self.probability,
            "count": self.count,
            "seed": self.seed,
            "fired": self.fired,
            "evaluated": self.evaluated,
        }


# The reference's failpoint catalog, one name per cut (the native store's
# store.aof_flush fires once that slice is ported). arm() does NOT enforce
# membership — tests arm synthetic names — but anything wired into product
# code must be listed here.
CATALOG: frozenset[str] = frozenset(
    {
        "store.get",
        "store.set",
        "store.cas",
        "store.aof_flush",
        "store_client.rpc",
        "journal.mark_processing",
        "journal.complete",
        "replay.dispatch",
        "proxy.dispatch",
        "health.probe",
        "engine.submit",
        "engine.prefill",
        "engine.decode_step",
        "engine.fused_decode",
        # SSE streaming seams: the engine serve layer's per-event token
        # write (firing = the upstream stream dies mid-emission → the
        # proxy's failover splice takes over) and the proxy's per-event
        # forward to the client (firing = a proxy-side dispatch failure
        # mid-stream — the journal cursor keeps the splice exact)
        "engine.stream",
        "proxy.stream_emit",
        "engine.snapshot",
        "engine.page_alloc",
        # tiered KV hierarchy: a firing kv_demote leaves the session
        # device-resident (parking is an optimization); a firing kv_promote
        # keeps the session parked and the triggering turn 429s typed —
        # context is preserved and a retry recovers
        "engine.kv_demote",
        "engine.kv_promote",
        "watcher.respawn",
        # fleet seams: the routing tier's replica choice (firing = a stale
        # routing table hands back a dead replica), the replica heartbeat
        # lease refresh (firing = a healthy replica's lease lapses → SUSPECT
        # flapping), and the session-affinity handoff off a dead replica
        # (firing = the session stays pinned to the corpse one more dispatch)
        "router.pick",
        "replica.lease",
        "replica.handoff",
    }
)


# The fast-path guard: fire() checks THIS dict's truthiness and returns.
# Mutations happen under _lock; the read path relies on the GIL-atomic
# dict read (a stale read during arm/disarm is acceptable by design).
_REGISTRY: dict[str, Failpoint] = {}
_lock = threading.Lock()


def arm(
    name: str,
    error: str = "FaultInjected",
    delay_ms: float = 0.0,
    probability: float = 1.0,
    count: int = -1,
    seed: int = 0,
) -> Failpoint:
    """Arm (or re-arm, resetting counters/RNG) one failpoint."""
    fp = Failpoint(
        name=name,
        error=error,
        delay_ms=float(delay_ms),
        probability=float(probability),
        count=int(count),
        seed=int(seed),
    )
    with _lock:
        _REGISTRY[name] = fp
    return fp


def disarm(name: str) -> bool:
    with _lock:
        return _REGISTRY.pop(name, None) is not None


def disarm_all() -> None:
    with _lock:
        _REGISTRY.clear()


def armed(name: str) -> bool:
    return name in _REGISTRY


def active() -> list[dict]:
    """Specs + live counters of every armed failpoint (API/CLI surface)."""
    with _lock:
        return [fp.to_dict() for fp in _REGISTRY.values()]


def _decide(name: str) -> tuple[float, BaseException | None] | None:
    """Evaluate one failpoint; returns (delay_s, error | None) when it
    fires, None when it doesn't. Mutates counters under the lock so two
    racing seams cannot both spend the same fire-count budget."""
    with _lock:
        fp = _REGISTRY.get(name)
        if fp is None:
            return None
        fp.evaluated += 1
        if fp.count == 0:
            return None  # budget spent: inert but still listed in active()
        if fp.probability < 1.0 and fp._rng.random() >= fp.probability:
            return None
        if fp.count > 0:
            fp.count -= 1
        fp.fired += 1
        delay_s = fp.delay_ms / 1000.0
        err: BaseException | None = None
        if fp.error != "none":
            err = ERROR_TYPES[fp.error](f"failpoint {name!r} injected {fp.error}")
    return delay_s, err


def fire(name: str) -> None:
    """Synchronous seam: sleep the injected delay, raise the injected
    error. The disarmed cost is one empty-dict check. Note a ``delay_ms``
    on a sync seam stalls the CALLING THREAD — for store/journal seams
    invoked from the daemon loop that is the whole event loop, which is a
    faithful model of a synchronously-hanging store; async seams use
    :func:`fire_async` so only the injected op slows down."""
    if not _REGISTRY:
        return
    hit = _decide(name)
    if hit is None:
        return
    delay_s, err = hit
    if delay_s > 0:
        time.sleep(delay_s)
    if err is not None:
        raise err


async def fire_async(name: str) -> None:
    """Async seam: identical semantics, but the delay yields the event
    loop (a failpoint must not freeze co-tenant traffic to delay one op)."""
    if not _REGISTRY:
        return
    hit = _decide(name)
    if hit is None:
        return
    delay_s, err = hit
    if delay_s > 0:
        import asyncio

        await asyncio.sleep(delay_s)
    if err is not None:
        raise err


# -- arming grammar --------------------------------------------------------
_FLOAT_KEYS = {"delay_ms", "probability"}
_INT_KEYS = {"count", "seed"}


def parse_spec(spec: str) -> list[dict]:
    """Parse the shared grammar into arm() kwargs (no side effects)."""
    out = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        name, _, opts = part.partition(":")
        name = name.strip()
        if not name:
            raise ValueError(f"failpoint spec {part!r} has no name")
        kw: dict = {"name": name}
        for item in filter(None, (s.strip() for s in opts.split(","))):
            key, sep, val = item.partition("=")
            key = key.strip()
            if not sep:
                raise ValueError(f"failpoint option {item!r} is not key=value")
            if key in _FLOAT_KEYS:
                kw[key] = float(val)
            elif key in _INT_KEYS:
                kw[key] = int(val)
            elif key == "error":
                kw[key] = val.strip()
            else:
                raise ValueError(
                    f"unknown failpoint option {key!r}; known: error, "
                    "delay_ms, probability, count, seed"
                )
        out.append(kw)
    return out


def arm_spec(spec: str) -> list[str]:
    """Arm every failpoint in a grammar string; returns the armed names."""
    names = []
    for kw in parse_spec(spec):
        arm(**kw)
        names.append(kw["name"])
    return names


def arm_from_env(env_var: str = "ATPU_FAULTS") -> list[str]:
    """Arm from the environment (engine subprocesses inherit the daemon's
    env, so a daemon-armed ``engine.*`` failpoint reaches every engine it
    spawns). No-op when unset."""
    import os

    spec = os.environ.get(env_var, "")
    return arm_spec(spec) if spec else []
