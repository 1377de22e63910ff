"""Serve-time pipeline parallelism: the layer stack and its KV arena staged
over ``pp``.

Reference: ``agentainer_tpu/parallel/pipeline.py`` — its serve half,
``_apply_stage_cached`` and ``make_serve_pipeline_forward``;
``pipeline_layer_specs``/``pipeline_param_specs`` are
``parallel/sharding.pipeline_param_specs`` here. Stage ``p`` of a pp mesh
holds layers ``[p·L/pp, (p+1)·L/pp)`` of the weights and of the arena
(``MeshCache`` with one ``[L/pp, B, S, KV, hd]`` arena a stage), and
``1/pp`` of the vocabulary: rows of ``embed`` and columns of ``lm_head``.
So a model deeper than one device's memory serves at all.

The reference is one SPMD program: every stage computes every tick, and
masked selects keep the active stage's activation and cache writes (its
``ppermute`` ticks are a JAX idiom, not copied here). The port is single-
controller, and its pipeline is ``models/llama.forward``'s own per-shard
loop over a pp mesh: each layer runs on its stage's shard alone, against
that stage's arena, with the same body and kernels as on one device, and
the stages meet in ``parallel/collectives``:

- the embedding is each stage's masked lookup of its vocab rows, summed by
  one ``all_reduce`` over pp (every token's row comes from one stage; the
  others add zeros);
- between stages the activation moves by ``handoff`` (pp - 1 a forward);
- the last stage's hidden state goes to every stage by one ``broadcast``
  (the reference's masked psum), each stage applies the final norm and its
  ``lm_head`` columns, and one ``all_gather`` joins the logits.

The training half (``make_pipeline_loss``) waits for the training slice.
"""

from __future__ import annotations

from ..models.configs import ModelConfig


def check_stages(cfg: ModelConfig, pp: int) -> None:
    """The reference's divisibility checks: the layers and the vocabulary
    split evenly over pp."""
    if cfg.n_layers % pp or cfg.vocab_size % pp:
        raise ValueError(f"pp={pp} must divide n_layers={cfg.n_layers} and vocab={cfg.vocab_size}")
