"""Pipeline parallelism: the layer stack staged over ``pp``, for serving
(with its KV arena) and for training (``make_pipeline_loss``).

Reference: ``agentainer_tpu/parallel/pipeline.py`` — its serve half,
``_apply_stage_cached`` and ``make_serve_pipeline_forward``, and its
training half, ``_apply_stage`` and ``make_pipeline_loss``;
``pipeline_layer_specs``/``pipeline_param_specs`` are
``parallel/sharding.pipeline_param_specs`` here. Stage ``p`` of a pp mesh
holds layers ``[p·L/pp, (p+1)·L/pp)`` of the weights and, serving, of the
arena (``MeshCache`` with one ``[L/pp, B, S, KV, hd]`` arena a stage), and
``1/pp`` of the vocabulary: rows of ``embed`` and columns of ``lm_head``.
So a model deeper than one device's memory serves and trains at all.

The reference is one SPMD program: every stage computes every tick, and
masked selects keep the active stage's activation and cache writes; its
training loss streams microbatches through ``M + pp - 1`` ticks of a
``lax.scan`` and discards the fill ticks. Those ``ppermute`` ticks are a JAX
idiom, not copied here. The port is single-controller, and its pipeline is
``models/llama.forward``'s own per-shard loop over a pp mesh: each layer
runs on its stage's shards alone (serving: one shard a stage; training: a
stage is a tp group, over dp as well), with the same body and kernels as on
one device, and the stages meet in ``parallel/collectives``:

- the embedding is each stage's masked lookup of its vocab rows, summed by
  one ``all_reduce`` over pp (every token's row comes from one stage; the
  others add zeros);
- between stages the activation moves by ``handoff`` (pp - 1 a forward);
- the last stage's hidden state goes to every stage by one ``broadcast``
  (the reference's masked psum), each stage applies the final norm and its
  ``lm_head`` columns; serving joins the logits by one ``all_gather``.

``make_pipeline_loss`` runs ``M`` microbatches through that forward in turn
and scores each by a vocab-parallel cross-entropy (``vocab_parallel_nll``,
which the tp training step uses over tp as well): no stage gathers the
whole vocabulary's logits. The loss is ``sum_m mean NLL_m / M``.
"""

from __future__ import annotations

import torch

from ..models.configs import ModelConfig
from .collectives import all_gather, all_reduce
from .mesh import Mesh
from .sharding import shard_batch


def check_stages(cfg: ModelConfig, pp: int) -> None:
    """The reference's divisibility checks: the layers and the vocabulary
    split evenly over pp."""
    if cfg.n_layers % pp or cfg.vocab_size % pp:
        raise ValueError(f"pp={pp} must divide n_layers={cfg.n_layers} and vocab={cfg.vocab_size}")


def vocab_parallel_nll(logits: list, targets: list, mesh: Mesh, axis: str) -> list[torch.Tensor]:
    """Each shard's NLL ``[B', T']`` of its ``targets`` under logits whose
    vocabulary splits over ``axis`` (``logits[s]`` ``[B', T', V/n]`` holds
    the columns ``[i·V/n, (i+1)·V/n)`` of shard ``s`` at index ``i``): the
    max of the gathered per-shard maxima (detached: the shift cancels in
    the log-sum-exp), the sum of exponentials by ``all_reduce``, the target
    logit by a masked ``all_reduce``; ``m + log(s) - target``, equal on every
    shard of a group."""
    width = logits[0].shape[-1]
    maxima = all_gather([x.detach().amax(dim=-1)[None] for x in logits], mesh, axis, dim=0)
    m = [g.amax(dim=0) for g in maxima]
    sums = all_reduce([torch.exp(x - mi[..., None]).sum(dim=-1) for x, mi in zip(logits, m)], mesh, axis)
    picked = []
    for s, (x, tgt) in enumerate(zip(logits, targets)):
        local = tgt.long() - mesh.index(axis, s) * width
        mine = (local >= 0) & (local < width)
        at = torch.gather(x, -1, torch.where(mine, local, torch.zeros_like(local))[..., None])[..., 0]
        picked.append(torch.where(mine, at, torch.zeros_like(at)))
    target = all_reduce(picked, mesh, axis)
    return [mi + torch.log(si) - ti for mi, si, ti in zip(m, sums, target)]


def mean_nll(logits: list, targets: list, mesh: Mesh, axis: str) -> torch.Tensor:
    """The mean NLL over the whole batch (every dp and sp shard's tokens,
    and every process's on a multi-host mesh): one shard of each dp × sp
    position scores its tokens, and one ``all_reduce`` over dp and sp sums
    them; a scalar on the first shard's device."""
    nll = vocab_parallel_nll(logits, targets, mesh, axis)
    reps = mesh.first_of(("dp", "sp"))
    total = all_reduce([nll[s].sum() for s in reps], mesh, ("dp", "sp"), shards=reps)[0]
    return total / (sum(nll[s].numel() for s in reps) * mesh.hosts)


def shard_inputs(batch: list, mesh: Mesh):
    """Each shard's inputs, targets and global positions from its dp rows
    ``[B', T + 1]``: ``[:, :-1]`` and ``[:, 1:]``, then its sp block of the
    T positions."""
    sp = mesh.shape["sp"]
    inps, tgts, poss = [], [], []
    for s, x in enumerate(batch):
        b, t = x.shape[0], x.shape[1] - 1
        if t % sp:
            raise ValueError(f"sequence {t} must divide by sp={sp}")
        t_loc, j = t // sp, mesh.index("sp", s)
        inps.append(x[:, j * t_loc : (j + 1) * t_loc])
        tgts.append(x[:, 1 + j * t_loc : 1 + (j + 1) * t_loc])
        poss.append((j * t_loc + torch.arange(t_loc, device=x.device)).expand(b, t_loc))
    return inps, tgts, poss


def make_pipeline_loss(cfg: ModelConfig, mesh: Mesh, n_microbatch: int | None = None, attn_impl=None):
    """Causal-LM loss with the layer stack pipelined over pp, composed with
    dp and tp (module docstring). Returns ``loss(trees, tokens)``: the
    shards' trees of a pp cut (``sharding.pipeline_param_specs``) and the
    ``[B, T + 1]`` tokens, or their dp rows per shard; each dp group's rows
    split into ``M`` microbatches (``n_microbatch``, pp by default), which
    run through the stages in turn. ``attn_impl``: the stages' attention,
    by default ``flash_mesh.make_trainable_causal_attention``."""
    from ..models.llama import forward
    from .flash_mesh import make_trainable_causal_attention

    pp = mesh.shape["pp"]
    M = int(n_microbatch or pp)
    if cfg.vocab_size % pp:
        raise ValueError(f"vocab {cfg.vocab_size} must divide by pp={pp}")
    attn = attn_impl or make_trainable_causal_attention(mesh)

    def loss(trees: list, tokens) -> torch.Tensor:
        batch = shard_batch(tokens, mesh, ("dp", None)) if isinstance(tokens, torch.Tensor) else tokens
        b_loc, dp = batch[0].shape[0], mesh.shape["dp"] * mesh.hosts
        if (b_loc * dp) % M:
            raise ValueError(f"batch {b_loc * dp} must divide into {M} microbatches")
        if b_loc % M:
            raise ValueError(f"batch {b_loc * dp} must divide into {M} microbatches within each of dp={dp} groups")
        mb = b_loc // M
        total = None
        for i in range(M):
            inps, tgts, poss = shard_inputs([x[i * mb : (i + 1) * mb] for x in batch], mesh)
            logits = forward(trees, cfg, inps, poss, cache=None, use_flash=False, attn_impl=attn, mesh=mesh,
                             local_logits=True)
            part = mean_nll(logits, tgts, mesh, "pp")
            total = part if total is None else total + part
        return total / M

    return loss
