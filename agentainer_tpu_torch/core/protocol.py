"""Wire-protocol constants the engine serve layer uses.

Reference: ``agentainer_tpu/core/protocol.py`` — an own copy of the header
names. These names ARE the contract with the control plane's proxy: keep
them identical to the reference's.
"""

from __future__ import annotations

REPLAY_HEADER = "X-Agentainer-Replay"
REQUEST_ID_HEADER = "X-Agentainer-Request-ID"
# end-to-end deadline: remaining milliseconds the caller will wait
DEADLINE_HEADER = "X-Agentainer-Deadline-Ms"
# engine process is up but its model is still loading
LOADING_HEADER = "X-Agentainer-Loading"
# engine drain in progress (treated like loading by the proxy)
DRAINING_HEADER = "X-Agentainer-Draining"
# the engine dropped the request by deadline/cancel policy
EXPIRED_HEADER = "X-Agentainer-Expired"
# the request itself broke prefill on a healthy engine
PREFILL_POISON_HEADER = "X-Agentainer-Prefill-Poisoned"

# SSE streaming (stream=true on /chat, the engine's streaming option)
STREAM_CONTENT_TYPE = "text/event-stream"
# the standard SSE reconnect header; also the splice cursor of a resumed
# stream: the serve layer re-emits the request's deterministic sequence and
# skips every offset <= this value
LAST_EVENT_ID_HEADER = "Last-Event-ID"
# SSE event names on the wire
STREAM_EVENT_TOKEN = "token"
STREAM_EVENT_DONE = "done"
STREAM_EVENT_ERROR = "error"
