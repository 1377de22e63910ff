"""Pipeline-parallel training: ``parallel/pipeline.make_pipeline_loss`` and
the train step over pp, composed with dp and tp, against the JAX
package's on the CPU.

Held against ``tests/test_pipeline.py``'s eight cases: pp=2 (one layer a
stage of tiny), M=4 microbatches, dp × pp, tp × pp and dp × tp × pp, each
two steps' losses and updated params against the reference's
``make_train_step`` on the same mesh shape (``tests/test_torch_train.py``'s
tolerances); the stages' ownership of the layers and of the vocabulary;
and the refusals, with the reference's messages.
"""

import dataclasses

import numpy as np
import pytest
import torch

from agentainer_tpu_torch import train as ttrain
from agentainer_tpu_torch.models import configs as tconfigs
from agentainer_tpu_torch.parallel import collectives
from agentainer_tpu_torch.parallel.pipeline import make_pipeline_loss
from tests.test_torch_train_mesh import assert_steps_match, cpu_mesh

CFG = tconfigs.get_config("tiny")  # 2 layers: pp=2 is one layer a stage
TOKENS = np.random.default_rng(11).integers(0, CFG.vocab_size, (4, 17)).astype(np.int32)


@pytest.mark.parametrize(
    "n,axes,kw",
    [
        (2, {"pp": 2}, {}),
        (2, {"pp": 2}, {"n_microbatch": 4}),
        (4, {"pp": 2}, {}),
        (4, {"tp": 2, "pp": 2}, {}),
        (8, {"tp": 2, "pp": 2}, {}),
    ],
    ids=["pp2", "pp2-M4", "dp2xpp2", "tp2xpp2", "dp2xtp2xpp2"],
)
def test_pp_steps_match_jax(n, axes, kw):
    """Two steps over each pipeline mesh against the reference's: every
    loss and every updated leaf; the loss falls."""
    losses, state, mesh = assert_steps_match("tiny", n, axes, TOKENS, **kw)
    assert losses[1] < losses[0]


def test_pp_stages_hold_layer_and_vocab_shards():
    """Each stage holds L/pp layers and 1/pp of the vocabulary (embed rows,
    lm_head columns); with tp its widths split too (wq ``[L/pp, D,
    H·hd/tp]``), and the stages' slices are distinct tensors."""
    mesh = cpu_mesh(4, tp=2, pp=2)
    init_fn, _, _ = ttrain.make_train_step(CFG, mesh)
    trees = init_fn(torch.Generator().manual_seed(0)).params.trees
    for s, tree in enumerate(trees):
        wq = tree["layers"]["wq"]
        assert wq.shape == (CFG.n_layers // 2, CFG.dim, CFG.n_heads * CFG.head_dim // 2)
        assert tree["embed"].shape == (CFG.vocab_size // 2, CFG.dim)
        assert tree["lm_head"].shape == (CFG.dim, CFG.vocab_size // 2)
    # shards 0 and 1 are the two stages of tp slice 0
    assert trees[0]["layers"]["wq"] is not trees[1]["layers"]["wq"]
    assert not torch.equal(trees[0]["layers"]["wq"], trees[1]["layers"]["wq"])
    assert trees[0]["embed"] is trees[2]["embed"]  # replicated over tp: one tensor on one device


def test_pp_step_logs_the_pipeline_collectives():
    """One microbatch's forward at pp=2 logs the embedding's all-reduce over
    pp, one handoff and one broadcast of the last stage's hidden state, and
    the vocab-parallel loss's gather of maxima and two all-reduces over pp."""
    mesh = cpu_mesh(2, pp=2)
    init_fn, step_fn, shard_batch = ttrain.make_train_step(CFG, mesh, n_microbatch=1)
    state = init_fn(torch.Generator().manual_seed(0))
    with collectives.record() as log:
        step_fn(state, shard_batch(TOKENS))
    kinds = [(e["kind"], e["axes"]) for e in log]
    assert kinds == [
        ("all_reduce", ("pp",)), ("handoff", ("pp",)), ("broadcast", ("pp",)),
        ("all_gather", ("pp",)), ("all_reduce", ("pp",)), ("all_reduce", ("pp",)),
    ]


@pytest.mark.parametrize(
    "n,axes,kw,match",
    [
        (4, {"pp": 4}, {}, "pp=4 must divide n_layers=2"),
        (4, {"sp": 2, "pp": 2}, {}, "pipeline parallelism does not compose with"),
        (4, {"ep": 2, "pp": 2}, {}, "pipeline parallelism does not compose with"),
    ],
    ids=["layers", "sp", "ep"],
)
def test_pp_refusals(n, axes, kw, match):
    cfg = tconfigs.get_config("tiny-moe") if "ep" in axes else CFG
    with pytest.raises(ValueError, match=match):
        ttrain.make_train_step(cfg, cpu_mesh(n, **axes), **kw)


def test_pipeline_loss_refuses_an_uneven_vocab_and_batch():
    """The reference's two refusals of ``make_pipeline_loss``: a vocabulary
    pp does not divide, and a batch that does not split into M
    microbatches."""
    mesh = cpu_mesh(2, pp=2)
    with pytest.raises(ValueError, match="vocab 511 must divide by pp=2"):
        make_pipeline_loss(dataclasses.replace(CFG, vocab_size=511), mesh)
    init_fn, step_fn, shard_batch = ttrain.make_train_step(CFG, mesh, n_microbatch=3)
    state = init_fn(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="batch 4 must divide into 3 microbatches"):
        step_fn(state, shard_batch(TOKENS))
