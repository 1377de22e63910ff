"""The training step: next-token LM loss and an AdamW update, on one device
or over a mesh.

Reference: ``agentainer_tpu/train.py`` — ``TrainState``, ``loss_fn`` and
``make_train_step``. There the step is one jit of forward, loss, backward
and the ``optax.adamw`` update over a (dp, tp, sp, ep, pp) mesh, the
params and the optimizer's moments sharded alike and GSPMD inserting the
gradient all-reduces. Here the update is ``torch.optim.AdamW`` with optax's
defaults: betas (0.9, 0.999), eps 1e-8 outside the square root, the decay
applied to the old parameter, the bias corrections from the incremented
count, every leaf decayed (norms and embeddings included). JAX donates the
state to the jitted step; the port updates the parameters and the
moments in place and returns the state with ``step`` advanced. Params are
f32, as the reference initializes them.

On one device (``device=``, no mesh) the attention is
``ops/attention.trainable_causal_attention`` (the hand-written prefill
kernel forward on the card, its plain version on the CPU, and the plain
attention's autograd recomputed for the backward, the reference's
``make_trainable_causal_attention``), and an MoE config trains through
``forward``'s dense-einsum ``_moe_mlp``.

Over a mesh (``parallel/``, every shard its own tensors, the shards
meeting only in ``parallel/collectives``):

- the params are cut once per shard (``sharding.shard_train_params``):
  each distinct slice is one optimizer leaf with its AdamW moments, its
  gradient the sum over the shards that hold it counted once, and every
  copy on another device given the same update;
- ``shard_batch`` places the tokens' rows over dp; each shard takes its sp
  block after the ``[:, :-1]`` slice, at its global positions;
- attention: over dp × tp (sp == pp == 1) each shard's own heads and rows
  (``flash_mesh.make_trainable_causal_attention``); over sp ``seq_attn``
  picks ``ulysses`` (when sp divides a shard's KV heads; ``auto`` takes it
  there), ``ring`` (else, and when asked) or ``none`` (k and v all-gathered
  over sp, each shard's queries at their global positions);
- the loss is a vocab-parallel cross-entropy over the shards' vocab slices
  (``pipeline.vocab_parallel_nll``), averaged over dp and sp;
- an MoE config runs ``parallel/expert.moe_expert_parallel``, the dense
  einsum over ep-sharded experts, as the reference's training MoE does;
- pp > 1 runs ``pipeline.make_pipeline_loss`` (``n_microbatch``
  microbatches; pp composes with dp and tp only, as in the reference);
- a mesh over processes (``parallel/dcn.host_mesh``) sums the loss and
  the gradients across them through ``torch.distributed``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .engine.llm import _engine_device
from .models.configs import ModelConfig
from .models.llama import forward, init_params
from .ops.attention import trainable_causal_attention
from .ops.cuda_attention import kernel_supported
from .parallel import flash_mesh
from .parallel.collectives import copy_to_replicas, reduce_grads
from .parallel.expert import moe_expert_parallel
from .parallel.mesh import Mesh
from .parallel.pipeline import make_pipeline_loss, mean_nll, shard_inputs
from .parallel.ring_attention import ring_attention
from .parallel.sharding import TrainShards, shard_batch as _shard_rows, shard_train_params
from .parallel.ulysses import ulysses_attention


class TrainState(NamedTuple):
    params: dict | TrainShards  # f32 leaves that require grad: one tree, or a mesh's cut
    opt_state: torch.optim.AdamW  # holds the moments and each leaf's count
    step: int


def loss_fn(params: dict, cfg: ModelConfig, tokens: torch.Tensor, attn_impl=None) -> torch.Tensor:
    """Causal LM loss: predict tokens[:, 1:] from tokens[:, :-1]; the mean
    NLL of the f32 logits' ``log_softmax``."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    positions = torch.arange(inputs.shape[1], device=tokens.device).expand(inputs.shape)
    logits = forward(
        params, cfg, inputs, positions, cache=None, use_flash=False, attn_impl=attn_impl
    )
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    return nll.mean()


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of a param tree, dicts walked in insertion order: the
    optimizer's parameter order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    return [tree]


def make_train_step(
    cfg: ModelConfig,
    mesh: Mesh | None = None,
    learning_rate: float = 3e-4,
    weight_decay: float = 0.01,
    seq_attn: str = "auto",
    n_microbatch: int | None = None,
    *,
    device=None,
):
    """Returns ``(init_fn, step_fn, shard_batch)``, the reference's roles.

    Without ``mesh``, on one device: the card unless ``device`` asks for
    the CPU, with the engine's rules (``engine/llm._engine_device``: no
    card, or on the card a head the attention kernel does not take,
    raises). Over ``mesh`` (module docstring), ``seq_attn`` and
    ``n_microbatch`` have the reference's meanings and refusals; on the
    card a shard's head the kernels do not take raises
    (``flash_mesh.resolve_mesh_flash``).

    - ``init_fn(generator=None, *, params=None, opt_state=None)``: f32
      params from ``init_params`` with ``generator``, or a copy of the
      given tree (a JAX one through ``models/convert.params_from_numpy``)
      in f32, on the device or cut over the mesh; ``opt_state``
      (``models/convert.adamw_state_from_numpy``) resumes the reference's
      optimizer with its moments and count, cut like the params.
    - ``step_fn(state, tokens)``: one step on ``[B, T + 1]`` tokens (over
      a mesh: ``shard_batch``'s), in place; returns ``(state, loss)`` with
      ``state.step`` one higher and the loss detached.
    - ``shard_batch(tokens)``: the tokens on the device, or each shard's
      dp rows on its device."""
    if mesh is None:
        return _one_device_step(cfg, device, learning_rate, weight_decay)
    return _mesh_step(cfg, mesh, learning_rate, weight_decay, seq_attn, n_microbatch)


def _adamw(params, learning_rate, weight_decay) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)


def _one_device_step(cfg, device, learning_rate, weight_decay):
    dev = _engine_device("cuda" if device is None else device, cfg)

    def init_fn(generator: torch.Generator | None = None, *, params=None, opt_state=None) -> TrainState:
        if params is None:
            if generator is None:
                raise ValueError("init_fn needs a generator or a params tree")
            params = init_params(cfg, generator, dtype=torch.float32, device=dev)
        else:
            params = _to_device(params, dev)
        for p in leaves(params):
            p.requires_grad_(True)
        opt = _adamw(leaves(params), learning_rate, weight_decay)
        if opt_state is not None:
            _load_adamw(opt, leaves(params), opt_state["step"], leaves(opt_state["exp_avg"]),
                        leaves(opt_state["exp_avg_sq"]))
        return TrainState(params, opt, 0)

    def step_fn(state: TrainState, tokens: torch.Tensor) -> tuple[TrainState, torch.Tensor]:
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(state.params, cfg, tokens, trainable_causal_attention)
        loss.backward()
        opt.step()
        return state._replace(step=state.step + 1), loss.detach()

    def shard_batch(tokens) -> torch.Tensor:
        return torch.as_tensor(tokens).to(dev)

    return init_fn, step_fn, shard_batch


def _seq_attention(cfg: ModelConfig, mesh: Mesh, seq_attn: str, on_card: bool):
    """The mesh's training attention over sp > 1 (``make_train_step``'s
    docstring), ``forward``'s ``seq_attn_impl``."""
    sp, tp = mesh.shape["sp"], mesh.shape["tp"]
    if seq_attn == "none":
        return flash_mesh.make_gathered_causal_attention(mesh)
    kv_local = cfg.n_kv_heads // tp
    if seq_attn == "auto":
        seq_attn = "ulysses" if kv_local % sp == 0 else "ring"
    if seq_attn == "ulysses":
        if on_card and kv_local % sp == 0 and not kernel_supported(
            cfg.n_heads // (tp * sp), kv_local // sp, cfg.head_dim
        ):
            raise ValueError(f"{cfg.name}: no attention kernel for a Ulysses shard at tp={tp}, sp={sp}")

        return lambda qs, ks, vs: ulysses_attention(qs, ks, vs, mesh, axis="sp")
    if seq_attn == "ring":
        return lambda qs, ks, vs: ring_attention(qs, ks, vs, mesh, axis="sp")
    raise ValueError(f"unknown seq_attn {seq_attn!r}")


def _mesh_step(cfg, mesh, learning_rate, weight_decay, seq_attn, n_microbatch):
    pp = mesh.shape["pp"]
    on_card = flash_mesh.resolve_mesh_flash(cfg, mesh.shape["tp"], mesh.device_list)
    attn_impl = seq_attn_impl = None
    if mesh.shape["sp"] == 1:
        attn_impl = flash_mesh.make_trainable_causal_attention(mesh)
    else:
        seq_attn_impl = _seq_attention(cfg, mesh, seq_attn, on_card)
    if pp > 1:
        if cfg.n_layers % pp:
            raise ValueError(f"pp={pp} must divide n_layers={cfg.n_layers}")
        others = {a: mesh.shape[a] for a in ("sp", "ep")}
        if any(v > 1 for v in others.values()):
            raise ValueError(f"pipeline parallelism does not compose with {others} yet; use a dp×tp×pp mesh")
        compute_loss = make_pipeline_loss(cfg, mesh, n_microbatch, attn_impl)
    else:
        moe_impl = (lambda hs, lps: moe_expert_parallel(hs, lps, cfg, mesh)) if cfg.is_moe else None

        def compute_loss(trees: list, batch: list) -> torch.Tensor:
            inps, tgts, poss = shard_inputs(batch, mesh)
            logits = forward(trees, cfg, inps, poss, cache=None, use_flash=False, attn_impl=attn_impl,
                             moe_impl=moe_impl, mesh=mesh, local_logits=True, seq_attn_impl=seq_attn_impl)
            return mean_nll(logits, tgts, mesh, "tp")

    def init_fn(generator: torch.Generator | None = None, *, params=None, opt_state=None) -> TrainState:
        if params is None:
            if generator is None:
                raise ValueError("init_fn needs a generator or a params tree")
            params = init_params(cfg, generator, dtype=torch.float32, device=mesh.device_list[0])
        shards = shard_train_params(params, mesh, cfg.is_moe, dtype=torch.float32)
        opt = _adamw(shards.leaves, learning_rate, weight_decay)
        if opt_state is not None:
            moments = [shard_train_params(opt_state[k], mesh, cfg.is_moe, dtype=torch.float32).leaves
                       for k in ("exp_avg", "exp_avg_sq")]
            _load_adamw(opt, shards.leaves, opt_state["step"], *moments)
        return TrainState(shards, opt, 0)

    def step_fn(state: TrainState, batch: list) -> tuple[TrainState, torch.Tensor]:
        shards, opt = state.params, state.opt_state
        opt.zero_grad(set_to_none=True)
        for copies in shards.copies:
            for c in copies:
                c.grad = None
        loss = compute_loss(shards.trees, batch)
        loss.backward()
        for leaf, copies, axes in zip(shards.leaves, shards.copies, shards.axes):
            reduce_grads([leaf, *copies], mesh, axes)
        opt.step()
        for leaf, copies, axes in zip(shards.leaves, shards.copies, shards.axes):
            copy_to_replicas([leaf, *copies], mesh, axes)
        return state._replace(step=state.step + 1), loss.detach()

    def shard_batch(tokens) -> list[torch.Tensor]:
        return _shard_rows(torch.as_tensor(tokens), mesh, ("dp", None))

    return init_fn, step_fn, shard_batch


def _to_device(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.detach().to(device=dev, dtype=torch.float32, copy=True)


def _load_adamw(opt: torch.optim.AdamW, params: list, step: int, mus: list, nus: list) -> None:
    """Each leaf's AdamW state from ``adamw_state_from_numpy``'s moments (in
    the leaves' order): the moments go to the leaf's device, and the count
    is the step torch's AdamW bias-corrects with (a CPU f32 scalar, as it
    keeps it itself)."""
    if len(mus) != len(params) or len(nus) != len(params):
        raise ValueError(f"optimizer state has {len(mus)}/{len(nus)} leaves for {len(params)} params")
    for p, mu, nu in zip(params, mus, nus):
        if mu.shape != p.shape or nu.shape != p.shape:
            raise ValueError(f"optimizer moment {tuple(mu.shape)} for a param {tuple(p.shape)}")
        opt.state[p] = {
            "step": torch.tensor(float(step), dtype=torch.float32),
            "exp_avg": mu.detach().to(device=p.device, dtype=p.dtype).clone(),
            "exp_avg_sq": nu.detach().to(device=p.device, dtype=p.dtype).clone(),
        }
