"""Serving engines — the programs agents run.

Reference: ``agentainer_tpu/engine/__init__.py``. The same open registry:

- ``echo``       mock-LLM parity agent (``engine/echo.py``), conversation
  memory in the store; standard library only, never imports torch;
- ``llm``        the PyTorch continuous-batching engine behind the
  standard-library serve layer (``engine/llm_serve.py``);
- ``assistant``  the persona flavor of ``llm`` (history flattened into each
  turn's prompt).

User engines register with ``register_engine`` in process, or
``ATPU_EXTRA_ENGINES=name:module.path,...`` in the daemon's environment
(each module exposes ``serve()``; engine processes import it by that path).
The reference's ``is_tpu_engine`` is ``is_gpu_engine`` here: the engines
that run a model on the card validate a model config at deploy time, share
weights by config name and are the only ones that see a GPU.
"""

from __future__ import annotations

import os

LLM_SERVE = "agentainer_tpu_torch.engine.llm_serve"

_BUILTIN: dict[str, str] = {
    "echo": "agentainer_tpu_torch.engine.echo",
    "llm": LLM_SERVE,
    "assistant": LLM_SERVE,  # persona preset of llm
}

# engines backed by the model runtime on the card (everything else is
# spawned with no visible GPU)
_GPU_BACKED: set[str] = {"llm", "assistant"}

_EXTRA: dict[str, str] = {}


def register_engine(name: str, module: str, gpu: bool = False) -> None:
    """Register a user engine: ``module`` must expose ``serve()`` (run in
    the engine process with the AGENTAINER_* env contract). ``gpu`` marks
    it model-backed (model-config validation + GPU placement)."""
    if not name or ":" in name or "," in name:
        raise ValueError(f"bad engine name {name!r}")
    _EXTRA[name] = module
    if gpu:
        _GPU_BACKED.add(name)


def is_gpu_engine(name: str) -> bool:
    return name in _GPU_BACKED


def _env_engines() -> dict[str, str]:
    out: dict[str, str] = {}
    for part in os.environ.get("ATPU_EXTRA_ENGINES", "").split(","):
        name, _, module = part.strip().partition(":")
        if name and module:
            out[name] = module
    return out


def engine_registry() -> dict[str, str]:
    """name → serve-module for every known engine (builtin + registered +
    environment-injected)."""
    reg = dict(_BUILTIN)
    reg.update(_env_engines())
    reg.update(_EXTRA)
    return reg


def known_engines() -> set[str]:
    return set(engine_registry())
