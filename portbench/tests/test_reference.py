"""The plain reference against the program on the CPU, at the sizes of the
port's ``tiny`` and ``tiny-moe``: through the model's forward, and through
the engine's served turns (a forked shared prefix, a session's later turns
over its resident KV)."""

import time

import pytest
import torch

from portbench import core
from portbench.reference.model import Reference
from portbench.shapes import shapes_of
from portbench.tests import tiny
from portbench.weights import fill_weights, make_weights

CONFIGS = {"tiny": tiny.TINY, "tiny-moe": tiny.TINY_MOE, "tiny-moe-int8": tiny.TINY_MOE_INT8}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_matches_the_forward(name):
    from agentainer_tpu_torch.models.configs import ModelConfig
    from agentainer_tpu_torch.models.llama import forward

    s = shapes_of(name, CONFIGS[name])
    weights = fill_weights(make_weights(s, "cpu", torch.float32), 2**31 + 3, "cpu")
    cfg = ModelConfig(name=name, vocab_size=s.vocab, dim=s.dim, n_layers=s.n_layers, n_heads=s.n_heads,
                      n_kv_heads=s.n_kv_heads, ffn_dim=s.ffn_dim, rope_theta=s.rope_theta, norm_eps=s.norm_eps,
                      n_experts=s.n_experts, experts_per_token=s.experts_per_token)
    tokens = torch.randint(0, s.vocab, (1, 37), generator=torch.Generator().manual_seed(5))
    got = forward(core.program_params(core.load_program(), weights), cfg, tokens,
                  torch.arange(37)[None], use_flash=False)[0]
    want = Reference(s, weights).logits([tokens[0].tolist()], [list(range(37))], "cpu")[0]
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_agrees_with_served_turns(name):
    s = shapes_of(name, CONFIGS[name])
    run = core.run_cell(s=s, raw=CONFIGS[name], mix_params=tiny.SESSIONS, cell=tiny.cell(contexts=6), seed=2**31 + 9,
                        seconds=2.0, trace=False, device=torch.device("cpu"), t_start=time.perf_counter(),
                        dtype=torch.float32)
    correct, checks = core.verdict(run, tiny.cell())
    assert correct, checks
    assert run["check"]["max_logit_gap"] < 1e-4
    after = run["record"]["counters"][1]
    assert after["prefix_hits"] > 0  # fresh contexts forked the shared prompt
    # a context served over several turns, its later ones over resident KV
    turns = [sum(1 for a, b in zip(c.positions, c.positions[1:]) if b != a + 1) + 1 for c in run["contexts"]]
    assert max(turns) >= 2
    # the check covered every served token of the contexts it drew
    assert run["check"]["served_tokens"] >= 20
