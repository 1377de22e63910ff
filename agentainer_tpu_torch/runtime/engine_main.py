"""Engine process entry point: ``python -m agentainer_tpu_torch.runtime.engine_main``.

Reference: ``agentainer_tpu/runtime/engine_main.py`` — the analogue of a
container's CMD. The local backend spawns this with the agent's identity,
port, GPU assignment and control-plane URL in the environment; the engine
module is imported lazily by its registry name, so the echo engine never
imports torch. What the reference adds for JAX (platform pinning, the
persistent compile cache, joining a multi-host cluster) has no counterpart:
the GPU an engine sees is set by ``CUDA_VISIBLE_DEVICES`` in the
environment the backend builds.
"""

from __future__ import annotations

import importlib
import logging
import os
import sys


def main() -> None:
    # engine log lines go to stdout, which the backend captures into the
    # engine's log file (the `docker logs` analogue)
    logging.basicConfig(
        level=logging.INFO,
        stream=sys.stdout,
        format="%(asctime)s %(name)s %(message)s",
        force=True,
    )
    # fault plane: engine-side failpoints (engine.*, store_client.rpc) arm
    # from the env the daemon exported; unset = registry empty = no-ops
    if os.environ.get("ATPU_FAULTS"):
        from .. import faults

        faults.arm_from_env()
    from ..engine import engine_registry

    engine = os.environ.get("AGENTAINER_ENGINE", "echo")
    module = engine_registry().get(engine)
    if module is None:
        print(f"unknown engine {engine!r}", file=sys.stderr)
        sys.exit(2)
    importlib.import_module(module).serve()


if __name__ == "__main__":
    main()
