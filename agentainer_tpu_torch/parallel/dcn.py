"""Multi-host backend: ``torch.distributed`` wiring so a mesh spans
processes, one a host.

Reference: ``agentainer_tpu/parallel/dcn.py`` — ``DistConfig``,
``dist_config_from_env``, ``init_distributed``, ``host_count`` and
``host_mesh``, over ``jax.distributed``. Activation is explicit (config or
environment), because joining is process-global and must happen before
any collective:

    ATPU_DIST_COORDINATOR=host0:9911   # the rendezvous address (process 0's)
    ATPU_DIST_NUM_PROCESSES=2
    ATPU_DIST_PROCESS_ID=0             # this host's rank

``init_distributed`` joins the default process group through a TCP
rendezvous at the coordinator, with gloo for CPU tensors and NCCL for CUDA
tensors (one group, the backend picked by each tensor's device; NCCL where
the torch build has it). Nothing switches when a backend fails: a CUDA
collective that NCCL refuses raises.

``host_mesh`` builds the multi-host mesh: each process holds the same grid
of its own devices (``parallel/mesh.make_mesh``), and dp spans the
processes, outermost (``Mesh.hosts``), so a step's only cross-host
traffic is the dp sums of ``parallel/collectives`` (the loss and the
gradients), while tp/sp/ep/pp stay inside each host.

``torch.distributed`` is imported inside the functions, as the reference
keeps ``jax`` there: the engine process calls ``init_distributed()`` at
boot and pays nothing when distribution is not configured.
"""

from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass(frozen=True)
class DistConfig:
    coordinator: str = ""
    num_processes: int = 1
    process_id: int = 0

    @property
    def enabled(self) -> bool:
        return bool(self.coordinator) and self.num_processes > 1


def dist_config_from_env() -> DistConfig:
    return DistConfig(
        coordinator=os.environ.get("ATPU_DIST_COORDINATOR", ""),
        num_processes=int(os.environ.get("ATPU_DIST_NUM_PROCESSES", "1") or 1),
        process_id=int(os.environ.get("ATPU_DIST_PROCESS_ID", "0") or 0),
    )


def backend() -> str:
    """The default group's backend string: gloo for CPU tensors, and NCCL
    for CUDA tensors where the torch build has it."""
    import torch.distributed as dist

    return "cpu:gloo,cuda:nccl" if dist.is_nccl_available() else "gloo"


def init_distributed(cfg: DistConfig | None = None) -> bool:
    """Join the process group when configured; no-op (False) otherwise.
    Safe to call more than once."""
    cfg = cfg or dist_config_from_env()
    if not cfg.enabled:
        return False
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    if not 0 <= cfg.process_id < cfg.num_processes:
        raise ValueError(f"process id {cfg.process_id} outside {cfg.num_processes} processes")
    dist.init_process_group(
        backend=backend(),
        init_method=f"tcp://{cfg.coordinator}",
        world_size=cfg.num_processes,
        rank=cfg.process_id,
    )
    return True


def host_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def host_mesh(tp: int = 1, sp: int = 1, ep: int = 1, pp: int = 1, devices: list | None = None):
    """The mesh over every process's devices with dp spanning the processes
    outermost: this process's shards on ``devices`` (its visible cards by
    default, as ``make_mesh``; ``["cpu"] * n`` names a CPU host). Model
    axes (tp/sp/ep/pp) must fit within one host's devices so their
    collectives never cross hosts."""
    import torch

    from .mesh import make_mesh

    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    per_host, hosts = len(devices), host_count()
    denom = tp * sp * ep * pp
    if denom > per_host or per_host % denom:
        # divisibility matters, not just fit: a model group that straddled
        # two hosts would put its collectives on the network
        raise ValueError(
            f"tp*sp*ep*pp={denom} must divide one host's {per_host} devices — "
            "model-parallel collectives must stay within a host"
        )
    if (per_host * hosts) % denom:
        raise ValueError(f"{per_host * hosts} devices not divisible by {denom}")
    mesh = make_mesh(tp=tp, sp=sp, ep=ep, pp=pp, devices=devices)
    mesh.hosts = hosts
    return mesh
