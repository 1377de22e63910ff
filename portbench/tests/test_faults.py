"""A run with the timed path broken underneath comes out not correct: the
harness's whole run (without its look for a card) on the CPU at a tiny
size, with each fault a served model can have planted in the program's
forward as the engine calls it. (The exchange between chips does not exist
in a one-chip cell.)"""

import time

import pytest
import torch

from portbench import core
from portbench.shapes import shapes_of
from portbench.tests import tiny


def state_unchanged(forward):
    """A step that leaves its state as it was: the KV it writes is undone."""
    def step(params, cfg, tokens, positions, cache=None, **kw):
        saved = [t.clone() for t in cache.tensors()]
        out = forward(params, cfg, tokens, positions, cache, **kw)
        for t, old in zip(cache.tensors(), saved):
            t.copy_(old)
        return out
    return step


def half_batch_left_out(forward):
    """A decode step that computes the first half of its lanes only."""
    def step(params, cfg, tokens, positions, cache=None, **kw):
        out = forward(params, cfg, tokens, positions, cache, **kw)
        if tokens.shape[1] == 1:
            out = out.clone()
            out[out.shape[0] // 2:] = 0.0
        return out
    return step


def token_altered(forward):
    """Every decode step's token altered where it is produced: the token
    after each lane's best (an off-by-one in the sampler) made its best."""
    def step(params, cfg, tokens, positions, cache=None, **kw):
        out = forward(params, cfg, tokens, positions, cache, **kw)
        if tokens.shape[1] == 1:
            out = out.clone()
            nxt = (out.argmax(-1, keepdim=True) + 1) % out.shape[-1]
            out.scatter_(-1, nxt, out.amax(-1, keepdim=True) + 1.0)
        return out
    return step


# each number a cell may compare, with a limit for float32 on the CPU: the
# widest gap (the dense cells) and the share of served tokens under the
# reference's mean logit, in % (the MoE cells)
NUMBERS = {
    "max_logit_gap": ("tiny", tiny.TINY, 1e-3, 100),
    "below_mean_share": ("tiny-moe-deep", tiny.TINY_MOE_INT8_DEEP, 2.0, 3),
}


def run(fault, number):
    import agentainer_tpu_torch.engine.llm as llm

    name, raw, limit, _ = NUMBERS[number]
    cell = tiny.cell(contexts=6, number=number, limit=limit)
    original = llm.forward
    if fault is not None:
        llm.forward = fault(original)
    try:
        out = core.run_cell(s=shapes_of(name, raw), raw=raw, mix_params=tiny.SESSIONS, cell=cell, seed=2**31 + 21,
                            seconds=2.0, trace=False, device=torch.device("cpu"), t_start=time.perf_counter(),
                            dtype=torch.float32)
    finally:
        llm.forward = original
    return core.verdict(out, cell)


@pytest.mark.parametrize("number", sorted(NUMBERS))
@pytest.mark.parametrize("fault", [state_unchanged, half_batch_left_out, token_altered])
def test_a_broken_step_is_not_correct(fault, number):
    correct, checks = run(fault, number)
    assert not correct
    assert checks[number]["value"] > NUMBERS[number][3] * checks[number]["limit"]


@pytest.mark.parametrize("number", sorted(NUMBERS))
def test_the_unbroken_run_is_correct(number):
    correct, checks = run(None, number)
    assert correct, checks
