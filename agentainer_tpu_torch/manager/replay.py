"""Replay worker — drains the journal back into live agents.

Re-implements the reference ReplayWorker (internal/requests/
replay_worker.go:16-198): a background loop on a 5s cadence finds agents with
pending journaled requests, checks the agent is running, and re-dispatches
each request. Two deliberate fixes over the reference:

- pending agents are discovered with SCAN-style iteration instead of a
  blocking ``KEYS agent:*:requests:pending`` every tick (replay_worker.go:60);
- replay dispatches straight into the proxy's dispatch function in-process
  (settling the same journal entry, idempotent by request id) instead of
  re-entering the server over localhost HTTP with magic headers
  (replay_worker.go:120-163).

Reference: ``agentainer_tpu/manager/replay.py``, copied.
"""

from __future__ import annotations

import asyncio
import time
from typing import Awaitable, Callable

from .. import faults
from ..core.protocol import DISPATCH_EXPIRED, DISPATCH_IN_FLIGHT
from ..core.spec import AgentStatus
from ..manager.agents import AgentManager
from ..manager.journal import RequestJournal, RequestStatus

# dispatch(agent_id, method, path, headers, body, request_id) -> (status, headers, body)
Dispatch = Callable[..., Awaitable[tuple[int, dict, bytes]]]


class ReplayWorker:
    def __init__(
        self,
        journal: RequestJournal,
        manager: AgentManager,
        dispatch: Dispatch,
        interval_s: float = 5.0,
        backend=None,
    ):
        self.journal = journal
        self.manager = manager
        self.dispatch = dispatch
        self.interval_s = interval_s
        # entries stuck PROCESSING longer than this are treated as orphaned
        # (daemon crashed mid-dispatch; 2x the proxy's 30s client timeout)
        self.processing_stale_s = 60.0
        self._task: asyncio.Task | None = None
        self._backend = backend
        self._unsub = None
        self._kick: asyncio.Event | None = None
        self._loop_ref: asyncio.AbstractEventLoop | None = None
        self.replayed_total = 0
        # store-blip observability: a scan that died (store error walking
        # the pending lists) and a dispatch that raised (store error inside
        # dispatch_to_agent) are survivable — the next tick retries — but
        # they must be countable, not silently passed
        self.scan_errors_total = 0
        self.dispatch_errors_total = 0
        self.last_error = ""

    async def start(self) -> None:
        self._loop_ref = asyncio.get_running_loop()
        self._kick = asyncio.Event()
        self._task = asyncio.create_task(self._loop(), name="replay-worker")
        # Event-driven drain: an engine coming back up
        # kicks a scan immediately instead of waiting out the 5s cadence —
        # the cadence remains as the safety net. Engine-process events come
        # from the backend watcher; the model-loaded signal arrives via the
        # control plane's /internal/engines/ready callback (server/app.py).
        if self._backend is not None and hasattr(self._backend, "subscribe_events"):
            from ..runtime.backend import EngineState

            def on_event(engine_id: str, state) -> None:
                if state == EngineState.RUNNING:
                    self.kick_threadsafe()

            self._unsub = self._backend.subscribe_events(on_event)

    def kick(self) -> None:
        """Request an immediate scan (must be called on the event loop)."""
        if self._kick is not None:
            self._kick.set()

    def kick_threadsafe(self) -> None:
        if self._loop_ref is not None and self._kick is not None:
            try:
                self._loop_ref.call_soon_threadsafe(self._kick.set)
            except RuntimeError:
                pass  # loop already closed

    async def stop(self) -> None:
        if self._unsub:
            self._unsub()
            self._unsub = None
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    async def _loop(self) -> None:
        while True:
            try:
                await asyncio.wait_for(self._kick.wait(), timeout=self.interval_s)
            except asyncio.TimeoutError:
                pass
            self._kick.clear()
            try:
                await self.scan_once()
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # a store outage mid-scan must not kill the worker — the
                # cadence retries — but it is counted, not silently passed
                self.scan_errors_total += 1
                self.last_error = f"{type(e).__name__}: {e}"

    async def scan_once(self) -> int:
        """One replay pass; returns number of successfully replayed requests."""
        replayed = 0
        for agent_id in self.journal.agents_with_pending():
            agent = self.manager.try_get(agent_id)
            # only replay into running agents (replay_worker.go:166-189)
            if agent is None or agent.status != AgentStatus.RUNNING:
                continue
            for req in self.journal.pending(agent_id):
                if req.status == RequestStatus.PROCESSING:
                    # in flight right now — unless the entry is stale (the
                    # daemon died mid-dispatch and nothing will ever settle
                    # it), in which case reclaim it
                    if time.time() - req.updated_at < self.processing_stale_s:
                        continue
                    self.journal.mark_pending(agent_id, req.id)
                elif req.status != RequestStatus.PENDING:
                    continue
                try:
                    await faults.fire_async("replay.dispatch")
                    status, _, _ = await self.dispatch(
                        agent_id,
                        req.method,
                        req.path,
                        req.headers,
                        req.body,
                        request_id=req.id,
                        deadline_at=req.deadline_at,
                    )
                except Exception as e:
                    # a dispatch that RAISES (store blip inside the proxy's
                    # settle path, injected fault) is isolated to this
                    # agent's drain — the other agents' queues still get
                    # their pass, and the entry stays journaled for the
                    # next tick
                    self.dispatch_errors_total += 1
                    self.last_error = f"{type(e).__name__}: {e}"
                    break
                if status == 429:
                    # engine shed the replay (overload): the entry went back
                    # to pending — stop hammering this agent until the next
                    # tick rather than burning the queue into a wall of 429s
                    break
                if status >= 0:
                    replayed += 1
                elif status in (DISPATCH_EXPIRED, DISPATCH_IN_FLIGHT):
                    # per-entry outcomes (dead-lettered, or another
                    # dispatcher owns it) — the rest of the queue still
                    # drains. journal.pending() pre-filters expired entries,
                    # so DISPATCH_EXPIRED here only catches a deadline
                    # crossing the list→dispatch gap.
                    continue
                else:
                    break  # engine went away mid-drain; next tick retries
        self.replayed_total += replayed
        return replayed
