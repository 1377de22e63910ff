"""The port's capture-ready prefill step against the JAX package on the CPU.

On the card every prefill chunk is one CUDA-graph replay of
``LLMEngine._prefill_step`` (one graph per bucket); on the CPU the same step
runs eagerly. Its inputs are static buffers (``_pinput``: start, last real
index, dense arena row, tokens; paged: the lane's table row in ``_pbt``),
so one step serves every slot, start and chunk length. Held here, on
``tiny`` in f32 with the JAX ``init_params`` weights and the reference's
defaults (prefix cache, speculation, deadlines), over the dense arena and
the paged one:

- greedy tokens equal the JAX engine's on traffic that sends two lanes'
  chunks through the same step, ends prompts on chunks shorter than their
  bucket, and starts a fresh session's prefill mid-arena after a prefix
  fork; every chunk went through the step;
- one step call against a full-chunk ``forward`` through the slot's row
  (dense) or the lane's table (paged): the last real token's logits and
  every KV byte the chunk wrote are equal.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentainer_tpu.engine.llm import LLMEngine as JEngine
from agentainer_tpu.engine.tokenizer import ByteTokenizer as JTok
from agentainer_tpu.models import configs as jconfigs
from agentainer_tpu.models.llama import init_params as jinit
from agentainer_tpu_torch.engine.llm import LLMEngine as TEngine
from agentainer_tpu_torch.engine.tokenizer import ByteTokenizer as TTok
from agentainer_tpu_torch.models import configs as tconfigs
from agentainer_tpu_torch.models.convert import params_from_numpy
from agentainer_tpu_torch.models.llama import forward

SHAPE = dict(max_batch=4, max_seq=256, decode_chunk=8, prefill_chunk=32)
ARENAS = {"dense": {}, "paged": dict(paged_kv=True, page_size=16)}
# ~90 tokens with the byte tokenizer: a fresh session opening with it forks
# the 64-token level registered by the first session, then prefills from 64
SHARED = "the quick brown fox jumps over the lazy dog " * 2


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = jconfigs.get_config("tiny"), tconfigs.get_config("tiny")
    jp = jinit(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jcfg, jp, tcfg, params_from_numpy(jax.tree.map(np.asarray, jp))


def _engines(weights, arena):
    jcfg, jp, tcfg, tp = weights
    teng = TEngine(tcfg, tp, TTok(tcfg.vocab_size), **SHAPE, **ARENAS[arena], device="cpu")
    teng.warmup()
    return JEngine(jcfg, jp, JTok(jcfg.vocab_size), **SHAPE, **ARENAS[arena]), teng


async def _traffic(eng) -> list[list[int]]:
    async def chat(session, message, n):
        return (await eng.chat(session=session, message=message, max_tokens=n))["tokens"]

    # two lanes at once through the step, each prompt ending on a chunk
    # shorter than its bucket (94 tokens: 32 + 32 + 30; 38: 32 + 6)
    a, b = await asyncio.gather(
        chat("a", SHARED + "alpha", 10), chat("b", "a second prompt, on another lane", 10)
    )
    # a fresh session forks the registered 64-token prefix and prefills
    # from position 64
    c = await chat("c", SHARED + "gamma ray", 10)
    # a second turn continues mid-arena
    a2 = await chat("a", " and then?", 10)
    return [a, b, c, a2]


@pytest.mark.parametrize("arena", list(ARENAS))
def test_prefill_step_tokens_match_jax(weights, arena):
    jeng, teng = _engines(weights, arena)
    calls = []
    step = teng._prefill_step

    def counting(bucket):
        calls.append((bucket, *teng._pinput[:3].tolist()))
        return step(bucket)

    teng._prefill_step = counting
    try:
        want = asyncio.run(_traffic(jeng))
        got = asyncio.run(_traffic(teng))
        m = teng.metrics()
    finally:
        jeng.shutdown()
        teng.shutdown()
    assert got == want
    assert m["prefix_hits"] >= 1
    # every chunk went through the step; two rows (lanes), a start past 0
    # after the fork, and a final chunk shorter than its bucket
    assert len(calls) == m["prefill_chunks"]
    starts = {start for _, start, _, _ in calls}
    assert len({row for *_, row in calls}) >= 2 and 64 in starts
    assert any(last + 1 < bucket for bucket, _, last, _ in calls)


@pytest.mark.parametrize("arena", list(ARENAS))
def test_prefill_step_equals_a_full_chunk_forward(weights, arena):
    """Slot 2 of 4 from position 40, 11 real tokens padded to bucket 32,
    with other rows' KV in the arena: the step's logits equal row 10 of a
    full forward of the chunk, and both leave the same KV bytes."""
    _, _, tcfg, tp = weights
    eng = TEngine(tcfg, tp, TTok(tcfg.vocab_size), **SHAPE, **ARENAS[arena], device="cpu")
    try:
        g = torch.Generator().manual_seed(0)
        cache = eng.cache
        kv = (cache.k, cache.v) if eng.paged else (cache.k_store, cache.v_store)
        for t in kv:
            t.copy_(torch.randn(t.shape, generator=g))
        slot, start, n = 2, 40, 11
        padded = torch.randint(0, tcfg.vocab_size, (32,), generator=g)
        padded[n:] = 0
        if eng.paged:
            eng._bt[slot, :5] = [7, 3, 11, 0, 9]  # positions up to 79
            eng._sync_table()
        saved = [t.clone() for t in kv]
        with torch.no_grad():
            got = eng._prefill(slot, padded.tolist(), start, n).clone()
            stepped = [t.clone() for t in kv]
            for t, s in zip(kv, saved):
                t.copy_(s)
            pos = torch.arange(start, start + 32, dtype=torch.int32)[None]
            if eng.paged:
                full = forward(tp, tcfg, padded[None], pos, cache, block_table=eng._dbt[slot : slot + 1])
            else:
                full = forward(tp, tcfg, padded[None], pos, cache.row(slot))
    finally:
        eng.shutdown()
    torch.testing.assert_close(got, full[0, n - 1], rtol=1e-5, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(stepped, kv))
    assert not all(torch.equal(a, b) for a, b in zip(stepped, saved))
