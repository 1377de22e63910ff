"""Serving engines — the programs agents run.

Reference: ``agentainer_tpu/engine/__init__.py``. The port registers the
engines it has ported so far: ``llm``, the PyTorch continuous-batching
engine behind the standard-library serve layer. Each module exposes
``serve()``.
"""

from __future__ import annotations

_BUILTIN: dict[str, str] = {
    "llm": "agentainer_tpu_torch.engine.llm_serve",
}


def engine_registry() -> dict[str, str]:
    """name → serve-module for every engine the port provides."""
    return dict(_BUILTIN)
