"""Key schema — kept 1:1 with the reference's Redis data model (SURVEY.md §2.2).

Reference writers/readers, for parity auditing:
- ``agent:{id}``               JSON agent record   (agent.go:510-530)
- ``agents:list``              set of agent IDs    (agent.go:525)
- ``agent:{id}:status``        legacy status key   (state_sync.go:203-206)
- ``agent:{id}:requests:{rid}``JSON request, 24h   (requests.go:100-107)
- ``agent:{id}:requests:pending|completed|failed`` lists (requests.go:111-261)
- ``health:{id}``              JSON health, 24h    (monitor.go:267-270)
- ``metrics:current:{id}``     JSON, 1h TTL        (collector.go:308)
- ``metrics:history:{id}``     zset by ts, 24h     (collector.go:313-321)
- ``logs:entries`` / ``audit:entries``  zsets, 7d  (logger.go:340-348)
- channel ``agent:status:{id}``         pub/sub    (state_sync.go:311-317)

Additions of the JAX package (no counterpart in the original Go reference):
- ``agent:{id}:kvcache:{session}``  serialized KV-cache pages for crash-resume
- ``agent:{id}:conversations``      conversation turns (was app-side in the
  reference's example agents, app.py:50-68 — here it is a framework feature)
- ``slices:allocations``            chip→agent placement map of the scheduler

Reference: ``agentainer_tpu/store/schema.py``, copied.
"""

from __future__ import annotations

# Retention, matching the reference's envelope (BASELINE.md).
REQUEST_TTL_S = 24 * 3600  # requests.go:106
HEALTH_TTL_S = 24 * 3600  # monitor.go:267-270
METRICS_CURRENT_TTL_S = 3600  # collector.go:308
METRICS_HISTORY_S = 24 * 3600  # collector.go:313-321
LOG_RETENTION_S = 7 * 24 * 3600  # logger.go:346-348


class Keys:
    AGENTS_LIST = "agents:list"
    LOGS = "logs:entries"
    AUDIT = "audit:entries"
    LOG_STREAM = "logs:stream"
    SLICE_ALLOCATIONS = "slices:allocations"

    @staticmethod
    def agent(agent_id: str) -> str:
        return f"agent:{agent_id}"

    @staticmethod
    def agent_status(agent_id: str) -> str:
        return f"agent:{agent_id}:status"

    @staticmethod
    def request(agent_id: str, request_id: str) -> str:
        return f"agent:{agent_id}:requests:{request_id}"

    @staticmethod
    def pending(agent_id: str) -> str:
        return f"agent:{agent_id}:requests:pending"

    @staticmethod
    def completed(agent_id: str) -> str:
        return f"agent:{agent_id}:requests:completed"

    @staticmethod
    def failed(agent_id: str) -> str:
        return f"agent:{agent_id}:requests:failed"

    @staticmethod
    def expired(agent_id: str) -> str:
        """Dead-letter list for requests whose deadline passed before they
        could be served — work nobody is waiting for anymore. Distinct from
        ``failed`` (which implies the engine tried and errored) so operators
        can requeue outage victims without replaying genuinely bad requests."""
        return f"agent:{agent_id}:requests:expired"

    @staticmethod
    def health(agent_id: str) -> str:
        return f"health:{agent_id}"

    @staticmethod
    def metrics_current(agent_id: str) -> str:
        return f"metrics:current:{agent_id}"

    @staticmethod
    def metrics_history(agent_id: str) -> str:
        return f"metrics:history:{agent_id}"

    @staticmethod
    def status_channel(agent_id: str) -> str:
        return f"agent:status:{agent_id}"

    STATUS_CHANNEL_PATTERN = "agent:status:*"
    PENDING_PATTERN = "agent:*:requests:pending"

    @staticmethod
    def internal_token(agent_id: str) -> str:
        """Per-engine store-API token. Deliberately OUTSIDE the agent:{id}:*
        namespace so engines cannot read each other's tokens through the
        store endpoint."""
        return f"internal:token:{agent_id}"

    @staticmethod
    def conversations(agent_id: str) -> str:
        """Legacy shared conversation list (all sessions interleaved);
        new turns land on per-session keys (conversations_session)."""
        return f"agent:{agent_id}:conversations"

    @staticmethod
    def conversations_session(agent_id: str, session: str) -> str:
        return f"agent:{agent_id}:conversations:{session}"

    @staticmethod
    def conversations_pattern(agent_id: str) -> str:
        """Matches the per-session lists only, not the legacy shared key."""
        return f"agent:{agent_id}:conversations:*"

    @staticmethod
    def agent_metrics_hash(agent_id: str) -> str:
        return f"agent:{agent_id}:metrics"

    @staticmethod
    def replica_lease(agent_id: str, engine_id: str) -> str:
        """Heartbeat lease for one engine replica: a JSON doc written with
        a TTL by the replica monitor. Lease age drives the per-replica
        ALIVE/SUSPECT/DEAD state machine; an expired (absent) lease is the
        durable evidence a replica stopped answering."""
        return f"agent:{agent_id}:replica:{engine_id}:lease"

    @staticmethod
    def replica_lease_pattern(agent_id: str) -> str:
        return f"agent:{agent_id}:replica:*:lease"

    @staticmethod
    def kvcache(agent_id: str, session_id: str) -> str:
        return f"agent:{agent_id}:kvcache:{session_id}"

    @staticmethod
    def kvcache_pattern(agent_id: str) -> str:
        return f"agent:{agent_id}:kvcache:*"
