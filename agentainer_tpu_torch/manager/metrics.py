"""Metrics plane — serving counters replacing docker container stats.

The reference samples docker ContainerStats (CPU%, memory, net, blkio) per
agent every 10s into ``metrics:current:{id}`` (1h TTL) and a 24h
``metrics:history:{id}`` sorted set (pkg/metrics/collector.go:202-322) — but
its collector is effectively dormant because registration depends on stubbed
storage + a broken pattern subscription (collector.go:92-101,324-355;
SURVEY.md §2 #9). Here the collector iterates live agents each tick, so it
cannot go dormant, and the sample unit is what matters on a TPU: request
throughput and latency from the proxy, plus engine counters (tokens/s, TTFT,
batch occupancy, KV/HBM usage) pulled from ``Backend.stats``.

Reference: ``agentainer_tpu/manager/metrics.py``, copied (the native data
plane's counter drain stays unset until that slice).
"""

from __future__ import annotations

import asyncio
import threading
import time

from ..core.spec import AgentStatus
from ..manager.agents import AgentManager
from ..store.base import Store
from ..store.schema import Keys, METRICS_CURRENT_TTL_S, METRICS_HISTORY_S


class MetricsPlane:
    def __init__(
        self, manager: AgentManager, store: Store, interval_s: float = 10.0, logs=None
    ):
        self.manager = manager
        self.store = store
        self.interval_s = interval_s
        self.logs = logs  # LogPlane for over-reservation warnings (optional)
        self._lock = threading.Lock()
        self._counters: dict[str, dict] = {}
        self._task: asyncio.Task | None = None
        # native data plane's per-agent request counters (drained per sample)
        self._native_drain = None
        # per-agent over-reservation latch (warn on transitions only)
        self._hbm_over: dict[str, bool] = {}

    def set_native_drain(self, drain) -> None:
        """``drain(agent_id) -> {requests, latency_sum, latency_max}`` from
        the C++ proxy; merged with Python-side counters at sample time."""
        self._native_drain = drain

    # -- proxy-side accounting ------------------------------------------
    def count_request(self, agent_id: str, latency_s: float = 0.0) -> None:
        with self._lock:
            c = self._counters.setdefault(
                agent_id,
                {"requests": 0, "latency_sum": 0.0, "latency_max": 0.0, "shed": 0},
            )
            c["requests"] += 1
            c["latency_sum"] += latency_s
            c["latency_max"] = max(c["latency_max"], latency_s)

    def count_shed(self, agent_id: str) -> None:
        """A request the proxy answered 429 for instead of journaling —
        the overload-shedding half of the deadline plane."""
        with self._lock:
            c = self._counters.setdefault(
                agent_id,
                {"requests": 0, "latency_sum": 0.0, "latency_max": 0.0, "shed": 0},
            )
            c["shed"] = c.get("shed", 0) + 1

    def _drain_counters(self, agent_id: str) -> dict:
        with self._lock:
            c = self._counters.pop(agent_id, None)
        c = c or {"requests": 0, "latency_sum": 0.0, "latency_max": 0.0, "shed": 0}
        if self._native_drain is not None:
            try:
                n = self._native_drain(agent_id)
                c["requests"] += n["requests"]
                c["latency_sum"] += n["latency_sum"]
                c["latency_max"] = max(c["latency_max"], n["latency_max"])
            except Exception:
                pass
        if not c["requests"]:
            return {
                "requests": 0,
                "latency_avg_s": 0.0,
                "latency_max_s": 0.0,
                "shed": c.get("shed", 0),
            }
        return {
            "requests": c["requests"],
            "latency_avg_s": c["latency_sum"] / c["requests"],
            "latency_max_s": c["latency_max"],
            "shed": c.get("shed", 0),
        }

    # -- collection loop (collector.go:202-221 cadence) ------------------
    async def start(self) -> None:
        self._task = asyncio.create_task(self._loop(), name="metrics-collector")

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                await asyncio.to_thread(self.sample_all)
            except asyncio.CancelledError:
                raise
            except Exception:
                pass

    def sample_all(self) -> None:
        for agent in self.manager.list_agents(sync_first=False):
            if agent.status == AgentStatus.RUNNING:
                self.sample_agent(agent.id)

    def sample_agent(self, agent_id: str) -> dict:
        agent = self.manager.try_get(agent_id)
        if agent is None:
            return {}
        now = time.time()
        sample = {"ts": now, "agent_id": agent_id, "proxy": self._drain_counters(agent_id)}
        if agent.engine_id:
            engine_stats = self.manager.backend.stats(agent.engine_id)
            if engine_stats:
                # the raw percentile-window arrays (ttft_samples etc., 256
                # floats each) belong to the live engine endpoint — persisted
                # into every 10s history entry they'd bloat the store by
                # ~15KB/sample (~130MB/day/agent) for no query value
                # (the engine dict carries the TTFT phase decomposition —
                # admission/queue-wait, ttft_prefill_ms_p50,
                # ttft_first_readback_ms_p50 — and the adaptive decode-chunk
                # histogram; only the raw sample arrays are dropped)
                sample["engine"] = {
                    k: v for k, v in engine_stats.items() if not k.endswith("_samples")
                }
                # prefix-arena rollup: ONLY the derived hit rate — the raw
                # counters (hits/misses/tokens_saved/occupancy/evictions)
                # are already in the engine dict above; duplicating them
                # here would double every history sample and split the
                # source of truth
                hits = engine_stats.get("prefix_hits")
                if hits is not None:
                    lookups = hits + engine_stats.get("prefix_misses", 0)
                    sample["prefix_cache"] = {
                        "enabled": engine_stats.get("prefix_cache"),
                        "hit_rate": round(hits / lookups, 3) if lookups else None,
                    }
                # speculative-decoding rollup: the derived acceptance rate
                # plus draft volume — "is speculation paying for itself on
                # this agent's traffic, or has gamma collapsed" in one
                # glance (raw counters stay in the engine dict above)
                drafted = engine_stats.get("spec_drafted")
                if drafted is not None:
                    accepted = engine_stats.get("spec_accepted", 0)
                    sample["speculative"] = {
                        "enabled": engine_stats.get("speculative"),
                        "rounds": engine_stats.get("spec_rounds", 0),
                        "drafted": drafted,
                        "accepted": accepted,
                        "acceptance_rate": (
                            round(accepted / drafted, 3) if drafted else None
                        ),
                    }
                # paged-KV-arena rollup: pool occupancy in one glance —
                # "how many sessions are resident, how full is the pool,
                # and is exhaustion backpressure firing" (raw gauges stay
                # in the engine dict above). This replaces the dense-only
                # kv_arena_bytes reading as the capacity audit: resident
                # sessions are bounded by pages, not max_batch.
                if engine_stats.get("paged_kv"):
                    total = engine_stats.get("kv_pages_total", 0)
                    free = engine_stats.get("kv_pages_free", 0)
                    sample["paged_kv"] = {
                        "enabled": True,
                        "pages_total": total,
                        "pages_free": free,
                        "pool_utilization": (
                            round(1.0 - free / total, 3) if total else None
                        ),
                        "resident_sessions": engine_stats.get("resident_sessions", 0),
                        "prefix_pinned_pages": engine_stats.get(
                            "kv_pages_prefix_pinned", 0
                        ),
                        "fragmentation_pct": engine_stats.get(
                            "kv_fragmentation_pct"
                        ),
                        "page_exhausted_total": engine_stats.get(
                            "page_exhausted_total", 0
                        ),
                    }
                # tiered-KV rollup: "where do this agent's sessions live"
                # — resident on device vs parked in host RAM (and how much
                # of that is int8), plus the tier-transfer traffic and how
                # much restore latency the prewarm overlap actually hid
                if engine_stats.get("kv_tiering"):
                    sample["kv_tiering"] = {
                        "enabled": True,
                        "host_sessions": engine_stats.get("tier_host_sessions", 0),
                        "host_bytes": engine_stats.get("tier_host_bytes", 0),
                        "quantized_pages": engine_stats.get(
                            "tier_quantized_pages", 0
                        ),
                        "demotions_total": engine_stats.get(
                            "tier_demotions_total", 0
                        ),
                        "promotions_total": engine_stats.get(
                            "tier_promotions_total", 0
                        ),
                        "pressure_demotions_total": engine_stats.get(
                            "tier_pressure_demotions_total", 0
                        ),
                        "prewarm_hits_total": engine_stats.get(
                            "tier_prewarm_hits_total", 0
                        ),
                        "promote_overlap_ms_p50": engine_stats.get(
                            "tier_promote_overlap_ms_p50"
                        ),
                    }
                # deadline/overload rollup: one place answering "is this
                # agent dropping work, and where" — proxy-side sheds (this
                # sample's proxy.shed) plus the engine's lifetime policy
                # counters and its current admission picture
                if engine_stats.get("cancelled_total") is not None:
                    sample["deadlines"] = {
                        "enabled": engine_stats.get("deadlines"),
                        "proxy_shed": sample["proxy"].get("shed", 0),
                        "engine_shed_total": engine_stats.get("shed_total", 0),
                        "cancelled_total": engine_stats.get("cancelled_total", 0),
                        "expired_total": engine_stats.get("expired_total", 0),
                        "queue_depth": engine_stats.get("queue_depth", 0),
                        "waiting_depth": engine_stats.get("waiting_depth", 0),
                        "draining": engine_stats.get("draining", False),
                    }
            # restart-watcher rollup: lives used, crash-loop backoff state,
            # and the give-up reason for a FAILED agent — "is this agent
            # flapping" belongs next to its serving counters
            watch_fn = getattr(self.manager.backend, "watch_stats", None)
            if watch_fn is not None:
                try:
                    watch = watch_fn(agent.engine_id)
                except Exception:
                    watch = None
                if watch:
                    # the raw attempt-timestamp log is test/debug surface,
                    # not a 10s history sample
                    watch.pop("respawn_attempts", None)
                    sample["restart_watch"] = watch
            # host-process half of the picture (CPU%/RSS via /proc): the
            # host side can be what throttles serving
            if hasattr(self.manager.backend, "host_stats"):
                host = self.manager.backend.host_stats(agent.engine_id)
                if host:
                    n = host.get("host_tenants")
                    if n and n > 1:
                        # multi-tenant host: the raw numbers are the WHOLE
                        # shared process, repeated in every tenant's sample —
                        # attribute an even share so summing over agents
                        # yields the process once, not N×
                        if host.get("host_cpu_pct") is not None:
                            host["host_cpu_pct_share"] = round(
                                host["host_cpu_pct"] / n, 2
                            )
                        if host.get("host_rss_bytes") is not None:
                            host["host_rss_bytes_share"] = host["host_rss_bytes"] // n
                    sample["host"] = host
        placement = self.manager.scheduler.placement(agent_id)
        if placement:
            sample["placement"] = placement.to_dict()
            # audit the scheduler's HBM claim against what the engine
            # actually reports (weights + KV arena per chip): an engine
            # over its reservation means the placement math is wrong and
            # co-scheduled agents can run out of memory together
            engine = sample.get("engine") or {}
            used = engine.get("hbm_bytes_per_chip_est")
            # placement.hbm_bytes is the agent's TOTAL reservation; the
            # engine reports PER-CHIP usage — compare per-chip to per-chip
            # (mismatched units would miss exactly the multi-chip
            # over-reservations the audit exists to catch)
            claimed_per_chip = placement.hbm_bytes // max(1, len(placement.chips))
            if used is not None and claimed_per_chip:
                over = used > claimed_per_chip
                sample["hbm"] = {
                    "claimed_bytes_per_chip": claimed_per_chip,
                    "engine_reported_bytes_per_chip": used,
                    "over_reservation": over,
                }
                # latch: warn once per false→true transition, not every 10 s
                was_over = self._hbm_over.get(agent_id, False)
                self._hbm_over[agent_id] = over
                if over and not was_over and self.logs is not None:
                    self.logs.warn(
                        "metrics",
                        f"agent {agent_id} engine reports {used} HBM bytes/chip "
                        f"over its {claimed_per_chip}-byte per-chip reservation",
                        agent_id=agent_id,
                    )
        self.store.set_json(Keys.metrics_current(agent_id), sample, ttl=METRICS_CURRENT_TTL_S)
        import json

        self.store.zadd(Keys.metrics_history(agent_id), now, json.dumps(sample))
        self.store.zremrangebyscore(Keys.metrics_history(agent_id), 0, now - METRICS_HISTORY_S)
        return sample

    # -- query APIs (collector.go:158-200) -------------------------------
    def current(self, agent_id: str) -> dict:
        return self.store.get_json(Keys.metrics_current(agent_id)) or {}

    def history(self, agent_id: str, since: float, until: float) -> list[dict]:
        import json

        out = []
        for raw in self.store.zrangebyscore(Keys.metrics_history(agent_id), since, until):
            try:
                out.append(json.loads(raw))
            except json.JSONDecodeError:
                continue
        return out
