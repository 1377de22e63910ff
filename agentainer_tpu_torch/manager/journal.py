"""Durable request journal — the signature feature's foundation.

Re-implements the reference's request persistence (internal/requests/
requests.go:27-275): every request bound for an agent is journaled *before*
dispatch, with a 24h TTL on the record and the request id RPUSH'd onto the
agent's pending list; completion LREM's exactly one pending entry and
archives the response; failure retries up to 3 times then dead-letters.

One deliberate change from the reference: journal entries carry an
``idempotency key`` (the request id) end-to-end into the engine's batching
scheduler, so a replay that races an in-flight original cannot run twice —
the reference only dedupes at the proxy via the X-Agentainer-Replay header
(server.go:506-522).

Reference: ``agentainer_tpu/manager/journal.py``, with the fleet's
re-attribution of claims (``set_replica``, ``reassign_replica``) and the
streaming cursor (``advance_stream``, ``StreamGapError``).
"""

from __future__ import annotations

import base64
import json
import time
import uuid
from dataclasses import dataclass, field
from typing import Any

from .. import faults
from ..store.base import Store
from ..store.schema import Keys, REQUEST_TTL_S

MAX_RETRIES = 3  # requests.go:95
# poisoned requests dead-letter faster than transient failures: the same
# journaled request failing prefill deterministically TWICE on a healthy
# engine is the input's fault, not the engine's — riding the full retry
# ladder just re-burns prefill compute and stretches MTTR
POISON_RETRIES = 2


class StreamGapError(RuntimeError):
    """The stream cursor was asked to advance past a hole. A gap can only
    mean tokens were emitted upstream but never acked through the journal
    — silently skipping it would hand the client a token sequence with a
    hole while claiming gaplessness, so this is a hard error."""


class RequestStatus:
    PENDING = "pending"
    PROCESSING = "processing"
    COMPLETED = "completed"
    FAILED = "failed"
    # deadline passed before the request could be served: dead-lettered
    # without charging a retry — nobody is waiting for the answer anymore
    EXPIRED = "expired"


@dataclass
class JournaledRequest:
    """Reference Request struct (requests.go:27-49)."""

    id: str
    agent_id: str
    method: str
    path: str
    headers: dict[str, str]
    body_b64: str
    status: str = RequestStatus.PENDING
    retry_count: int = 0
    max_retries: int = MAX_RETRIES
    response: dict[str, Any] | None = None
    error: str = ""
    created_at: float = field(default_factory=time.time)
    updated_at: float = field(default_factory=time.time)
    # absolute wall-clock instant after which the caller has given up; None
    # = no deadline (pre-deadline entries and deadlines=false deployments)
    deadline_at: float | None = None
    # fleet: which engine replica the winning dispatcher forwarded to (set
    # at acquire_processing). Fleet repair reassigns a dead replica's
    # PROCESSING entries by this attribution instead of waiting out the
    # replay worker's staleness window.
    replica_id: str = ""
    # streaming checkpoint: highest token offset acked to the client, -1 =
    # nothing emitted (buffered requests never touch it). Advanced per
    # event via advance_stream's CAS so replay-after-crash and a live
    # failover can never double-emit the same offset.
    stream_offset: int = -1

    def expired(self, now: float | None = None) -> bool:
        return self.deadline_at is not None and (now or time.time()) > self.deadline_at

    @property
    def body(self) -> bytes:
        return base64.b64decode(self.body_b64) if self.body_b64 else b""

    def to_dict(self) -> dict[str, Any]:
        return {
            "id": self.id,
            "agent_id": self.agent_id,
            "method": self.method,
            "path": self.path,
            "headers": self.headers,
            "body_b64": self.body_b64,
            "status": self.status,
            "retry_count": self.retry_count,
            "max_retries": self.max_retries,
            "response": self.response,
            "error": self.error,
            "created_at": self.created_at,
            "updated_at": self.updated_at,
            "deadline_at": self.deadline_at,
            "replica_id": self.replica_id,
            "stream_offset": self.stream_offset,
        }

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "JournaledRequest":
        return JournaledRequest(
            id=d["id"],
            agent_id=d["agent_id"],
            method=d["method"],
            path=d["path"],
            headers=dict(d.get("headers", {})),
            body_b64=d.get("body_b64", ""),
            status=d.get("status", RequestStatus.PENDING),
            retry_count=int(d.get("retry_count", 0)),
            max_retries=int(d.get("max_retries", MAX_RETRIES)),
            response=d.get("response"),
            error=d.get("error", ""),
            created_at=float(d.get("created_at", 0)),
            updated_at=float(d.get("updated_at", 0)),
            deadline_at=(
                float(d["deadline_at"]) if d.get("deadline_at") is not None else None
            ),
            replica_id=d.get("replica_id", ""),
            stream_offset=int(d.get("stream_offset", -1)),
        )


class RequestJournal:
    def __init__(self, store: Store, ttl_s: float = REQUEST_TTL_S):
        self.store = store
        self.ttl_s = ttl_s

    def _save(self, req: JournaledRequest) -> None:
        req.updated_at = time.time()
        # keep the record's remaining TTL rather than resetting to 24h on
        # every touch; first save sets the full window (requests.go:100-107)
        remaining = self.store.ttl(Keys.request(req.agent_id, req.id))
        ttl = self.ttl_s if remaining is None else remaining
        self.store.set_json(Keys.request(req.agent_id, req.id), req.to_dict(), ttl=ttl)

    # -- API (requests.go:64-275) ---------------------------------------
    def store_request(
        self,
        agent_id: str,
        method: str,
        path: str,
        headers: dict[str, str] | None = None,
        body: bytes = b"",
        request_id: str | None = None,
        deadline_at: float | None = None,
    ) -> JournaledRequest:
        req = JournaledRequest(
            id=request_id or str(uuid.uuid4()),
            agent_id=agent_id,
            method=method,
            path=path,
            headers=dict(headers or {}),
            body_b64=base64.b64encode(body).decode() if body else "",
            deadline_at=deadline_at,
        )
        self.store.set_json(
            Keys.request(agent_id, req.id), req.to_dict(), ttl=self.ttl_s
        )
        self.store.rpush(Keys.pending(agent_id), req.id)
        return req

    def get(self, agent_id: str, request_id: str) -> JournaledRequest | None:
        raw = self.store.get_json(Keys.request(agent_id, request_id))
        return None if raw is None else JournaledRequest.from_dict(raw)

    def store_response(
        self,
        agent_id: str,
        request_id: str,
        status_code: int,
        headers: dict[str, str] | None = None,
        body: bytes = b"",
    ) -> None:
        faults.fire("journal.complete")
        req = self.get(agent_id, request_id)
        if req is None:
            return
        req.status = RequestStatus.COMPLETED
        req.response = {
            "status_code": status_code,
            "headers": dict(headers or {}),
            "body_b64": base64.b64encode(body).decode() if body else "",
        }
        self._save(req)
        self.store.lrem(Keys.pending(agent_id), 1, request_id)
        self.store.rpush(Keys.completed(agent_id), request_id)

    def acquire_processing(
        self, agent_id: str, request_id: str, replica_id: str = ""
    ) -> bool:
        """Claim the pending→processing transition with a store-level
        compare-and-set; returns whether THIS caller won the claim.

        mark_processing used to be a read-modify-write: proxy dispatch and a
        replay tick could both read PENDING across an await boundary and
        dispatch the same entry twice before the engine's idempotency memo
        existed. The CAS closes that: exactly one dispatcher sees True; the
        loser backs off without forwarding anything. A concurrent unrelated
        touch (retry accounting from another dispatch) fails the swap too —
        re-read and retry, bounded."""
        faults.fire("journal.mark_processing")
        key = Keys.request(agent_id, request_id)
        for _ in range(4):
            raw = self.store.get(key)
            if raw is None:
                return False
            req = JournaledRequest.from_dict(json.loads(raw))
            if req.status != RequestStatus.PENDING:
                return False
            req.status = RequestStatus.PROCESSING
            req.replica_id = replica_id
            req.updated_at = time.time()
            new = json.dumps(req.to_dict(), separators=(",", ":"))
            if self.store.cas(key, raw, new):
                return True
        return False

    def set_replica(self, agent_id: str, request_id: str, replica_id: str) -> bool:
        """Re-attribute an in-flight claim to the replica ACTUALLY serving
        it (the proxy's cross-replica retry). Without this, an entry
        claimed against replica A but retried onto B stays attributed to
        A — A's later death would reassign (and re-dispatch) work B is
        still executing, and B's death would NOT reassign work that died
        with it. CAS-guarded and PROCESSING-only: a concurrent settle or
        repair reassignment wins, and this becomes a no-op."""
        key = Keys.request(agent_id, request_id)
        for _ in range(4):
            raw = self.store.get(key)
            if raw is None:
                return False
            req = JournaledRequest.from_dict(json.loads(raw))
            if req.status != RequestStatus.PROCESSING:
                return False
            if req.replica_id == replica_id:
                return True
            req.replica_id = replica_id
            req.updated_at = time.time()
            new = json.dumps(req.to_dict(), separators=(",", ":"))
            if self.store.cas(key, raw, new):
                return True
        return False

    def reassign_replica(self, agent_id: str, engine_id: str) -> int:
        """Fleet repair: a replica died — every PROCESSING entry attributed
        to it goes back to PENDING immediately (the winning dispatcher's
        forward can never settle; its HTTP call got connection-reset). The
        replay worker's staleness reclaim remains the safety net for
        entries with no/stale attribution. Returns how many were reassigned.
        Idempotent and double-execution-safe: re-dispatch re-enters the
        acquire_processing CAS, and the engine memoizes by request id."""
        n = 0
        for rid in self.pending_ids(agent_id):
            req = self.get(agent_id, rid)
            if (
                req is not None
                and req.status == RequestStatus.PROCESSING
                and req.replica_id == engine_id
            ):
                self.mark_pending(agent_id, rid)
                n += 1
        return n

    def advance_stream(self, agent_id: str, request_id: str, offset: int) -> bool:
        """Ack one streamed token offset against the entry's stream cursor.

        CAS semantics mirror acquire_processing: of any two emitters racing
        the same offset (live dispatch vs replay-after-crash, or two
        failover legs overlapping), exactly one advance wins — the loser
        gets False and must NOT forward the event. Contract:

          offset == cursor + 1  → advance, True  (the only legal step)
          offset <= cursor      → False          (duplicate; drop the event)
          offset >  cursor + 1  → StreamGapError (hard error, never skipped)
        """
        key = Keys.request(agent_id, request_id)
        for _ in range(4):
            raw = self.store.get(key)
            if raw is None:
                return False
            req = JournaledRequest.from_dict(json.loads(raw))
            if offset <= req.stream_offset:
                return False
            if offset > req.stream_offset + 1:
                raise StreamGapError(
                    f"stream cursor gap for {agent_id}/{request_id}: "
                    f"acked={req.stream_offset}, offered={offset}"
                )
            req.stream_offset = offset
            req.updated_at = time.time()
            new = json.dumps(req.to_dict(), separators=(",", ":"))
            if self.store.cas(key, raw, new):
                return True
        return False

    def mark_processing(self, agent_id: str, request_id: str) -> None:
        """Best-effort processing flag for forced re-dispatch paths (manual
        replay of settled entries); racing dispatchers must use
        acquire_processing instead."""
        req = self.get(agent_id, request_id)
        if req is not None and req.status == RequestStatus.PENDING:
            req.status = RequestStatus.PROCESSING
            self._save(req)

    def mark_pending(self, agent_id: str, request_id: str) -> None:
        """Revert an in-flight entry to pending (engine died mid-dispatch —
        the crash-heuristic path; no retry is charged)."""
        req = self.get(agent_id, request_id)
        if req is not None and req.status == RequestStatus.PROCESSING:
            req.status = RequestStatus.PENDING
            self._save(req)

    def mark_failed(
        self, agent_id: str, request_id: str, error: str, poison: bool = False
    ) -> None:
        """Retry accounting: under the cap the id stays pending for the next
        replay pass; at the cap it is dead-lettered (requests.go:228-275).

        ``poison=True`` is the deterministic-failure fast path (engine
        reported the request itself breaks prefill): the cap drops to
        POISON_RETRIES and the dead-letter reason is prefixed, so the same
        input failing twice on a healthy engine is quarantined in ~one
        replay tick instead of riding the respawn/backoff ladder. The
        entry stays requeue-able (requeue resets the count)."""
        req = self.get(agent_id, request_id)
        if req is None:
            return
        req.retry_count += 1
        cap = min(POISON_RETRIES, req.max_retries) if poison else req.max_retries
        req.error = f"poisoned prefill: {error}" if poison else error
        if req.retry_count >= cap:
            req.status = RequestStatus.FAILED
            self._save(req)
            self.store.lrem(Keys.pending(agent_id), 1, request_id)
            self.store.rpush(Keys.failed(agent_id), request_id)
        else:
            req.status = RequestStatus.PENDING
            self._save(req)

    def mark_expired(self, agent_id: str, request_id: str, reason: str = "") -> None:
        """Dead-letter an entry whose deadline passed (or whose caller
        disconnected): off the pending list, onto the ``expired`` list, no
        retry charged. Replaying it would burn engine time on an answer
        nobody reads."""
        req = self.get(agent_id, request_id)
        if req is None or req.status in (RequestStatus.COMPLETED, RequestStatus.EXPIRED):
            return
        req.status = RequestStatus.EXPIRED
        if reason:
            req.error = reason
        self._save(req)
        self.store.lrem(Keys.pending(agent_id), 1, request_id)
        self.store.rpush(Keys.expired(agent_id), request_id)

    def requeue(self, agent_id: str, request_id: str) -> JournaledRequest | None:
        """Operator recovery: put a dead-lettered (failed/expired) entry back
        on the pending list with retry_count reset, so a transient-outage
        victim replays without hand-editing the store. The deadline is
        cleared — the operator asking for a requeue IS the new waiter, and
        the stale deadline would expire it again immediately. The status
        flip is a CAS (same discipline as acquire_processing): of two
        concurrent requeues exactly one does the list moves, so the id can
        never land on the pending list twice."""
        key = Keys.request(agent_id, request_id)
        for _ in range(4):
            raw = self.store.get(key)
            if raw is None:
                return None
            req = JournaledRequest.from_dict(json.loads(raw))
            if req.status not in (RequestStatus.FAILED, RequestStatus.EXPIRED):
                return None
            source = (
                Keys.failed(agent_id)
                if req.status == RequestStatus.FAILED
                else Keys.expired(agent_id)
            )
            req.status = RequestStatus.PENDING
            req.retry_count = 0
            req.error = ""
            req.deadline_at = None
            req.updated_at = time.time()
            new = json.dumps(req.to_dict(), separators=(",", ":"))
            if self.store.cas(key, raw, new):
                self.store.lrem(source, 1, request_id)
                self.store.rpush(Keys.pending(agent_id), request_id)
                return req
        return None

    def pending_ids(self, agent_id: str) -> list[str]:
        return self.store.lrange_str(Keys.pending(agent_id), 0, -1)

    def pending(self, agent_id: str) -> list[JournaledRequest]:
        """Live pending entries. Entries whose deadline has passed are
        dead-lettered to the ``expired`` list here — both the replay worker
        and the proxy's depth accounting read through this path, so a
        crash-stale queue self-cleans instead of replaying hours-dead work."""
        out = []
        now = time.time()
        for rid in self.pending_ids(agent_id):
            req = self.get(agent_id, rid)
            if req is None:
                # record expired (24h TTL) — drop the dangling id
                self.store.lrem(Keys.pending(agent_id), 1, rid)
            elif req.expired(now):
                self.mark_expired(agent_id, rid, reason="deadline exceeded")
            else:
                out.append(req)
        return out

    def by_status(self, agent_id: str, status: str) -> list[JournaledRequest]:
        if status == RequestStatus.PENDING:
            return [r for r in self.pending(agent_id) if r.status == RequestStatus.PENDING]
        if status == RequestStatus.PROCESSING:
            return [r for r in self.pending(agent_id) if r.status == RequestStatus.PROCESSING]
        if status == RequestStatus.COMPLETED:
            key = Keys.completed(agent_id)
        elif status == RequestStatus.FAILED:
            key = Keys.failed(agent_id)
        elif status == RequestStatus.EXPIRED:
            key = Keys.expired(agent_id)
        else:
            from ..core.errors import InvalidInput

            raise InvalidInput(
                f"unknown request status {status!r}; known: pending, processing, "
                "completed, failed, expired"
            )
        out = []
        for rid in self.store.lrange_str(key, 0, -1):
            req = self.get(agent_id, rid)
            if req is not None:
                out.append(req)
        return out

    def stats(self, agent_id: str) -> dict[str, int]:
        return {
            "pending": self.store.llen(Keys.pending(agent_id)),
            "completed": self.store.llen(Keys.completed(agent_id)),
            "failed": self.store.llen(Keys.failed(agent_id)),
            "expired": self.store.llen(Keys.expired(agent_id)),
        }

    def pending_depth(self, agent_id: str) -> int:
        """O(1) queue depth for admission decisions (proxy shedding)."""
        return self.store.llen(Keys.pending(agent_id))

    def total_pending(self) -> int:
        """Pending depth summed across every agent — the global shedding
        ceiling's input. SCAN-style like agents_with_pending."""
        total = 0
        for key in self.store.scan(Keys.PENDING_PATTERN):
            total += self.store.llen(key)
        return total

    def agents_with_pending(self) -> list[str]:
        """Agents that currently have queued requests.

        Uses SCAN-style iteration, not the reference's blocking KEYS on every
        5s tick (replay_worker.go:60).
        """
        out = []
        for key in self.store.scan(Keys.PENDING_PATTERN):
            agent_id = key.split(":")[1]
            if self.store.llen(key) > 0:
                out.append(agent_id)
        return out
