"""The one-device training step: next-token LM loss and an AdamW update.

Reference: ``agentainer_tpu/train.py`` — ``TrainState``, ``loss_fn`` and
``make_train_step`` on a mesh with ``sp == pp == 1`` and one device. There
the step is one jit of forward, loss, backward and the ``optax.adamw``
update, and its attention is ``make_trainable_causal_attention``: the
Pallas ``flash_prefill`` forward under a ``custom_vjp`` whose backward
recomputes the einsum reference's VJP. Here the same attention is
``ops/attention.trainable_causal_attention`` (the hand-written prefill
kernel forward on the card, its plain version on the CPU, and the plain
attention's autograd recomputed for the backward), and the update is
``torch.optim.AdamW`` with optax's defaults: betas (0.9, 0.999), eps 1e-8
outside the square root, the decay applied to the old parameter, the bias
corrections from the incremented count, every leaf decayed (norms and
embeddings included).

JAX donates the state to the jitted step; the port updates the parameters
and the optimizer's moments in place and returns the state with ``step``
advanced. Params are f32, as the reference initializes them. An MoE config
trains through ``forward``'s dense-einsum ``_moe_mlp``, as the reference's
one-device step does (no ``moe_impl``).

The mesh axes of the reference (``tp``/``sp``/``pp``/``ep`` > 1, ring and
Ulysses attention, the pipeline) come with the ``parallel/`` slice; this
step takes a device, not a mesh, so none of them can be asked for.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .engine.llm import _engine_device
from .models.configs import ModelConfig
from .models.llama import forward, init_params
from .ops.attention import trainable_causal_attention


class TrainState(NamedTuple):
    params: dict  # the model's tree of f32 leaves that require grad
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
    device=None,
    learning_rate: float = 3e-4,
    weight_decay: float = 0.01,
):
    """Returns ``(init_fn, step_fn, shard_batch)``, the reference's roles on
    one device: the card unless ``device`` asks for the CPU, with the
    engine's rules (``engine/llm._engine_device``: no card, or on the card
    a head the attention kernel does not take, raises).

    - ``init_fn(generator=None, *, params=None, opt_state=None)``: f32
      params from ``init_params`` with ``generator``, or a copy of the
      given tree (a JAX one through ``models/convert.params_from_numpy``)
      on the device in f32; ``opt_state`` (``models/convert.adamw_state_from_numpy``)
      resumes the reference's optimizer with its moments and count.
    - ``step_fn(state, tokens)``: one step on ``[B, T + 1]`` tokens, in
      place; returns ``(state, loss)`` with ``state.step`` one higher and
      the loss detached.
    - ``shard_batch(tokens)``: the tokens on the device.
    """
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
        opt = torch.optim.AdamW(
            leaves(params), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay,
        )
        if opt_state is not None:
            _load_adamw(opt, params, opt_state)
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


def _to_device(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.detach().to(device=dev, dtype=torch.float32, copy=True)


def _load_adamw(opt: torch.optim.AdamW, params: dict, state: dict) -> None:
    """Each leaf's AdamW state from ``adamw_state_from_numpy``'s trees: the
    moments go to the leaf's device, and the count is the step torch's
    AdamW bias-corrects with (a CPU f32 scalar, as it keeps it itself)."""
    mus, nus = leaves(state["exp_avg"]), leaves(state["exp_avg_sq"])
    ps = leaves(params)
    if len(mus) != len(ps) or len(nus) != len(ps):
        raise ValueError(f"optimizer state has {len(mus)}/{len(nus)} leaves for {len(ps)} params")
    for p, mu, nu in zip(ps, mus, nus):
        if mu.shape != p.shape or nu.shape != p.shape:
            raise ValueError(f"optimizer moment {tuple(mu.shape)} for a param {tuple(p.shape)}")
        opt.state[p] = {
            "step": torch.tensor(float(state["step"]), dtype=torch.float32),
            "exp_avg": mu.to(device=p.device, dtype=p.dtype).clone(),
            "exp_avg_sq": nu.to(device=p.device, dtype=p.dtype).clone(),
        }
