"""Expert parallelism for MoE layers.

Reference: ``agentainer_tpu/parallel/expert.py`` — ``make_routed_moe`` and
``moe_expert_parallel``. Experts split over ``ep``: each shard holds
``E/ep`` experts' weights (and, under tp, a ``F/tp`` slice of each
expert's width). Two compute strategies, each a ``moe_impl(hs, lps)`` for
``models/llama.forward`` over a mesh: ``hs[s]``/``lps[s]`` are shard
``s``'s normed hidden state and layer weights, and every shard gets the
layer's output.

- ``make_routed_moe`` (the serving default for ep > 1): each shard routes
  with the replicated router over the full expert set and runs
  ``models/llama._moe_mlp_routed`` on its own experts (``base = ep index ·
  E/ep``), so per-token MLP FLOPs go as k, not E;
- ``moe_expert_parallel`` (the dense fallback): each shard computes its
  experts for every token and keeps its slice of the combine weights.

Either way the partial outputs are summed by one ``all_reduce`` over tp
and ep together (the reference's GSPMD psum over tp and its manual psum
over ep), the only collective of the layer.
"""

from __future__ import annotations

from ..models.configs import ModelConfig
from ..models.llama import _moe_mlp, _moe_mlp_routed
from .collectives import all_reduce
from .mesh import Mesh


def _local_experts(cfg: ModelConfig, mesh: Mesh) -> int:
    ep = mesh.shape["ep"]
    if cfg.n_experts % ep:
        raise ValueError(f"ep={ep} must divide n_experts={cfg.n_experts}")
    return cfg.n_experts // ep


def make_routed_moe(mesh: Mesh, cfg: ModelConfig, capacity_factor: float = 2.0):
    """Top-k token dispatch over ep-sharded experts (module docstring)."""
    e_loc = _local_experts(cfg, mesh)

    def impl(hs, lps):
        parts = [
            _moe_mlp_routed(
                hs[s], lps[s], cfg, capacity_factor=capacity_factor, base=mesh.index("ep", s) * e_loc
            )
            for s in range(mesh.size)
        ]
        return all_reduce(parts, mesh, ("tp", "ep"))

    return impl


def moe_expert_parallel(hs, lps, cfg: ModelConfig, mesh: Mesh):
    """The dense-einsum MoE over ep-sharded experts (module docstring)."""
    e_loc = _local_experts(cfg, mesh)
    parts = [
        _moe_mlp(hs[s], lps[s], cfg, base=mesh.index("ep", s) * e_loc) for s in range(mesh.size)
    ]
    return all_reduce(parts, mesh, ("tp", "ep"))
