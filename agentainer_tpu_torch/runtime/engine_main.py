"""Engine process entry point: ``python -m agentainer_tpu_torch.runtime.engine_main``.

Reference: ``agentainer_tpu/runtime/engine_main.py`` — the analogue of a
container's CMD. The local backend spawns this with the agent's identity,
port, GPU assignment and control-plane URL in the environment; the engine
module is imported lazily by its registry name, so the echo engine never
imports torch. A GPU-backed engine joins the multi-host process group at
boot when ``ATPU_DIST_*`` asks for one (``parallel/dcn.py``), and exits 3
when it cannot, as the reference's does: an engine configured to span
hosts must not serve a local-only topology. What the reference adds for
JAX alone (platform pinning, the persistent compile cache) has no
counterpart: the GPU an engine sees is set by ``CUDA_VISIBLE_DEVICES`` in
the environment the backend builds.
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
    from ..engine import engine_registry, is_gpu_engine

    engine = os.environ.get("AGENTAINER_ENGINE", "echo")
    if is_gpu_engine(engine):
        # the engine processes run the model, so they are what joins the
        # process group (one engine per host, ATPU_DIST_* set by the
        # operator); the control plane never blocks on its rendezvous
        from ..parallel.dcn import init_distributed

        try:
            init_distributed()
        except Exception as e:
            print(f"[engine] torch.distributed init failed: {e}", file=sys.stderr)
            sys.exit(3)
    module = engine_registry().get(engine)
    if module is None:
        print(f"unknown engine {engine!r}", file=sys.stderr)
        sys.exit(2)
    importlib.import_module(module).serve()


if __name__ == "__main__":
    main()
