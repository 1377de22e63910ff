"""Wire-protocol constants shared by the proxy, replay worker, and engine
serve layer. One definition site: these names ARE the contract between the
control plane and engines — a rename that only lands on one side silently
breaks dispatch classification or header handling.

Reference: ``agentainer_tpu/core/protocol.py`` — an own copy, name for name.
"""

from __future__ import annotations

# proxy ↔ engine headers
REPLAY_HEADER = "X-Agentainer-Replay"
REQUEST_ID_HEADER = "X-Agentainer-Request-ID"
# end-to-end deadline: remaining milliseconds the caller will wait; the
# proxy journals the absolute instant and forwards the remaining budget
DEADLINE_HEADER = "X-Agentainer-Deadline-Ms"
# engine process is up but its model is still loading
LOADING_HEADER = "X-Agentainer-Loading"
# engine SIGTERM drain in progress (treated like loading: entry stays
# pending, replays on respawn)
DRAINING_HEADER = "X-Agentainer-Draining"
# the engine dropped the request by deadline/cancel policy — dead-letter,
# never archive the notice as the request's completed response
EXPIRED_HEADER = "X-Agentainer-Expired"
# the request itself broke prefill on a HEALTHY engine (deterministic
# input fault, not a crash): the proxy charges poison accounting instead
# of archiving the 500 — two strikes dead-letters it (journal.mark_failed
# poison=True)
PREFILL_POISON_HEADER = "X-Agentainer-Prefill-Poisoned"

# SSE streaming (stream=true on /chat, features.streaming)
STREAM_CONTENT_TYPE = "text/event-stream"
# standard SSE reconnect header; doubles as the proxy→engine splice
# cursor on mid-stream failover: the engine serve layer re-emits the
# deterministic sequence and skips every offset <= this value
LAST_EVENT_ID_HEADER = "Last-Event-ID"
# SSE event names on the wire
STREAM_EVENT_TOKEN = "token"
STREAM_EVENT_DONE = "done"
STREAM_EVENT_ERROR = "error"

# dispatch_to_agent sentinel outcomes (never valid HTTP statuses)
DISPATCH_ENGINE_GONE = -1  # connection refused / engine vanished → stays pending
DISPATCH_FAILED = -2  # timeout or protocol error → retry accounted
DISPATCH_EXPIRED = -3  # deadline passed → dead-lettered, no retry charged
DISPATCH_IN_FLIGHT = -4  # lost the processing CAS → another dispatcher owns it
