"""The port's runtime contracts (``agentainer_tpu_torch/analysis/contracts.py``)
against the reference's HLO contracts (``tests/test_hlo_contracts.py``), on
the CPU.

Both packages build the reference's contract engine (``tiny``, paged +
speculative + fused, the reference fixture's options) over the SAME weights
(the JAX ``init_params`` tree through ``params_from_numpy``) and warm it up.
The reference's scripted mixed workload (prefill buckets, the decode
ladder's rungs, speculation on repetitive JSON, two sessions forking one
persona, a resident session's next turn, a lane arriving while a fused loop
runs) then runs on the JAX engine under ``recompile_budget(..., 0)`` and on
the port under ``capture_budget(engine, 0)`` and ``buffers_in_place``: both
contracts hold and the greedy tokens are equal. Two negative cases mirror
``test_donation_contract_catches_silent_copy``: a step that rebinds the
arena to a copy fails ``buffers_in_place``, and a dispatch of an unwarmed
step key fails ``capture_budget``. ``no_implicit_sync`` and
``launches_per_replay`` are held on the card
(``tests/test_torch_cuda.py``); here ``no_implicit_sync`` runs its block
unchanged.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from agentainer_tpu.analysis.hlo_contracts import engine_jit_fns, recompile_budget
from agentainer_tpu.engine.llm import LLMEngine as JEngine
from agentainer_tpu.engine.tokenizer import ByteTokenizer as JTok
from agentainer_tpu.models import configs as jconfigs
from agentainer_tpu.models.llama import init_params as jinit
from agentainer_tpu_torch.analysis.contracts import (
    ContractViolation,
    buffers_in_place,
    capture_budget,
    check,
    no_implicit_sync,
)
from agentainer_tpu_torch.engine.llm import LLMEngine as TEngine
from agentainer_tpu_torch.engine.tokenizer import ByteTokenizer as TTok
from agentainer_tpu_torch.models import configs as tconfigs
from agentainer_tpu_torch.models.convert import params_from_numpy

# the reference fixture's options (tests/test_hlo_contracts.py)
OPTS = {
    "max_batch": 4, "max_seq": 256, "decode_chunk": 8, "prefill_chunk": 32,
    "paged_kv": True, "speculative": True, "fused_decode": True,
}
JSON_LOOP = '{"tool": "search", "args": {"q": "w", "n": 5}}\n' * 4
PERSONA = "You are a terse assistant. Answer in one word. " * 4


@pytest.fixture(scope="module")
def weights():
    jcfg = jconfigs.get_config("tiny")
    jp = jinit(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def make(weights, side: str, **opts):
    jcfg, jp, tp = weights
    kw = dict(OPTS, **opts)
    if side == "jax":
        eng = JEngine(jcfg, jp, JTok(jcfg.vocab_size), **kw)
    else:
        tcfg = tconfigs.get_config("tiny")
        eng = TEngine(tcfg, tp, TTok(tcfg.vocab_size), **kw, device="cpu")
    eng.warmup()
    return eng


@pytest.fixture(scope="module")
def engines(weights):
    engs = {side: make(weights, side) for side in ("jax", "torch")}
    yield engs
    for e in engs.values():
        e.shutdown()


def _gen(engine, prompt, n=6, session=""):
    return asyncio.run(engine.generate(prompt, max_tokens=n, session=session))["tokens"]


def _mixed_workload(engine) -> list[list[int]]:
    """The reference's recompile-budget script
    (``test_recompile_budget_mixed_workload``); every greedy stream."""
    out = []
    for words in (2, 9, 20):  # prefill buckets 8/16/32
        out.append(_gen(engine, "tok " * words, n=2))
    for c in (1, 2, 4, 8):  # decode ladder rungs: max_tokens = c+1 picks rung c
        out.append(_gen(engine, "ladder probe", n=c + 1))
    out.append(_gen(engine, JSON_LOOP, n=24))  # speculation on repetitive JSON
    out.append(_gen(engine, PERSONA + "What is two plus two?", n=4, session="hc-a"))
    out.append(_gen(engine, PERSONA + "Name a color.", n=4, session="hc-b"))
    out.append(_gen(engine, "and another thing", n=4, session="hc-a"))

    async def staggered():  # a lane arriving while a fused loop runs
        t1 = asyncio.ensure_future(engine.generate(JSON_LOOP, max_tokens=24))
        await asyncio.sleep(0.05)
        t2 = asyncio.ensure_future(engine.generate("late lane", max_tokens=6))
        return await asyncio.gather(t1, t2)

    out += [r["tokens"] for r in asyncio.run(staggered())]
    return out


def test_mixed_workload_holds_both_contracts_and_matches_jax(engines):
    jeng, teng = engines["jax"], engines["torch"]
    _gen(jeng, "hello", n=2)
    _gen(teng, "hello", n=2)
    with recompile_budget(lambda: engine_jit_fns(jeng), budget=0):
        want = _mixed_workload(jeng)
    with capture_budget(teng, 0) as seen, buffers_in_place(teng) as kinds, no_implicit_sync():
        got = _mixed_workload(teng)
    assert got == want
    assert teng.worker_errors == 0, teng.last_worker_error
    # the workload reached every kind of step the engine dispatches
    assert {k[0] for k in seen} == set(kinds) == {"prefill", "fused"}, (seen, kinds)
    assert {k for k in seen} <= set(teng._step_keys())
    m = teng.metrics()
    assert m["inloop_spec_accepted"] > 0 and m["fused_loops_total"] > 0


@pytest.fixture(scope="module")
def plain_engine(weights):
    """A dense engine with host-side speculation and the decode ladder: the
    prefill, decode and verify steps as their own dispatches."""
    eng = make(weights, "torch", paged_kv=False, fused_decode=False, inloop_spec=False)
    yield eng
    eng.shutdown()


def test_buffers_in_place_across_prefill_decode_and_verify(plain_engine):
    with capture_budget(plain_engine, 0), buffers_in_place(plain_engine) as kinds:
        _gen(plain_engine, "tok " * 20, n=6)
        _gen(plain_engine, JSON_LOOP, n=24)
    assert set(kinds) == {"prefill", "decode", "verify"}, kinds
    assert plain_engine.metrics()["spec_rounds"] > 0


def test_buffers_in_place_catches_a_step_that_rebinds_the_arena(weights):
    """A prefill step that writes a copy of the arena and rebinds
    ``engine.cache`` to it (what a lost in-place write looks like): the
    contract must fail loudly, naming the step and the tensor."""
    eng = make(weights, "torch", paged_kv=False, fused_decode=False)
    try:
        step_fn = eng._step_fn

        def copying(key):
            fn = step_fn(key)
            if key[0] != "prefill":
                return fn

            def step():
                out = fn()
                c = eng.cache
                eng.cache = type(c)(c.k_store.clone(), c.v_store.clone())
                return out

            return step

        eng._step_fn = copying
        with pytest.raises(ContractViolation, match=r"prefill.*cache\.k_store rebound to a copy"):
            with buffers_in_place(eng):
                _gen(eng, "a prompt", n=2)
    finally:
        eng.shutdown()


def test_capture_budget_catches_an_unwarmed_step_key(plain_engine):
    """A decode rung the warmup never ran (3): one key outside the warmed
    set fails a budget of 0 and passes a budget of 1."""
    ladder = plain_engine._decode_ladder
    try:
        with pytest.raises(ContractViolation, match=r"capture budget exceeded: 1 step keys.*'decode', 3"):
            with capture_budget(plain_engine, 0):
                plain_engine._decode_ladder = [3]
                _gen(plain_engine, "a b c", n=3)
        plain_engine._decode_ladder = ladder
        with capture_budget(plain_engine, 1):
            plain_engine._decode_ladder = [3]
            _gen(plain_engine, "a b c", n=3)
    finally:
        plain_engine._decode_ladder = ladder


def test_contract_hooks_nest_and_unwind(plain_engine):
    assert "_run_step" not in plain_engine.__dict__
    with capture_budget(plain_engine, 0) as seen:
        with buffers_in_place(plain_engine) as kinds:
            _gen(plain_engine, "nested", n=2)
        _gen(plain_engine, "outer only", n=2)
    assert sum(seen.values()) > sum(kinds.values()) > 0
    assert "_run_step" not in plain_engine.__dict__


def test_check_collects_every_failure():
    class Never:
        def __init__(self, why):
            self.why = why

        def failures(self, subject):
            return [f"{self.why}: {subject}"]

    class Always:
        def failures(self, subject):
            return []

    check("x", Always())
    with pytest.raises(ContractViolation, match="(?s)a: x.*b: x"):
        check("x", Never("a"), Always(), Never("b"))
