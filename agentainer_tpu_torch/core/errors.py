"""Framework error taxonomy.

The reference returns ``fmt.Errorf`` strings surfaced as HTTP 4xx/5xx by the
API layer (e.g. "agent not found" → 404, server.go:236-241). Typed exceptions
here map to status codes in server/app.py.

Reference: ``agentainer_tpu/core/errors.py``, copied.
"""


class AgentainerError(Exception):
    http_status = 500


class AgentNotFound(AgentainerError):
    http_status = 404

    def __init__(self, agent_id: str):
        super().__init__(f"agent not found: {agent_id}")
        self.agent_id = agent_id


class InvalidInput(AgentainerError):
    http_status = 400


class InvalidTransition(AgentainerError):
    http_status = 409

    def __init__(self, agent_id: str, src: str, op: str):
        super().__init__(f"agent {agent_id} is {src}; cannot {op}")


class ResourceExhausted(AgentainerError):
    """Slice scheduler cannot place the agent (not enough chips / HBM)."""

    http_status = 409


class BackendError(AgentainerError):
    http_status = 502


class Unauthorized(AgentainerError):
    http_status = 401
