"""Self-speculative decoding in the port against the JAX package on the CPU.

Engines serve ``tiny`` in f32 with the same weights (the JAX
``init_params`` tree through ``params_from_numpy``) and the reference's
defaults: prefix cache, speculation and deadlines on. Held here
(tests/test_speculative.py's bars):

- greedy tokens with speculation on equal the JAX engine's and the port's
  own with it off, alone and beside a temperature lane, over the dense and
  the paged arena;
- on sequential greedy traffic ``spec_rounds``, ``spec_drafted`` and
  ``spec_accepted`` equal the JAX engine's (sampled lanes are not compared
  token by token: threefry and torch generators differ);
- a junk drafter forces rejections and the tokens stay identical; the
  acceptance EMA collapses;
- the rewind invariant: garbage KV above a slot's live length changes no
  later token; the paged rewind is a page-tail truncation that keeps
  mapped prefix pages;
- the drafter (``_spec_lookup``, ``_spec_draft``) equals the JAX one on
  random streams.

Engines are built once per module; each test uses its own session names
and counts in deltas.
"""

import asyncio
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from agentainer_tpu.engine.llm import LLMEngine as JEngine
from agentainer_tpu.engine.tokenizer import ByteTokenizer as JTok
from agentainer_tpu.models import configs as jconfigs
from agentainer_tpu.models.llama import init_params as jinit
from agentainer_tpu_torch.engine.llm import SPEC_EMA_FLOOR
from agentainer_tpu_torch.engine.llm import LLMEngine as TEngine
from agentainer_tpu_torch.engine.tokenizer import ByteTokenizer as TTok
from agentainer_tpu_torch.models import configs as tconfigs
from agentainer_tpu_torch.models.convert import params_from_numpy

# tests/test_speculative.py's shapes
SHAPE = dict(max_batch=4, max_seq=256, decode_chunk=8, prefill_chunk=32)
PAGED = dict(paged_kv=True, page_size=16)
# tool-call-loop shaped prompt: the trailing n-gram always has an earlier
# occurrence, so the drafter proposes full buckets
JSON_LOOP = '{"tool": "search", "args": {"q": "w", "n": 5}}\n' * 4
SPEC_COUNTERS = ("spec_rounds", "spec_drafted", "spec_accepted", "spec_rejected")


@pytest.fixture(scope="module")
def engines():
    jcfg, tcfg = jconfigs.get_config("tiny"), tconfigs.get_config("tiny")
    jp = jinit(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))

    def port(**kw):
        eng = TEngine(tcfg, tp, TTok(tcfg.vocab_size), **SHAPE, **kw, device="cpu")
        eng.warmup()
        return eng

    e = SimpleNamespace(
        j=JEngine(jcfg, jp, JTok(jcfg.vocab_size), **SHAPE),
        jp=JEngine(jcfg, jp, JTok(jcfg.vocab_size), **SHAPE, **PAGED),
        t=port(),
        tp=port(**PAGED),
        off=port(speculative=False),
    )
    yield e
    for eng in vars(e).values():
        eng.shutdown()


def run(coro):
    return asyncio.run(coro)


def _counters(eng):
    return {k: getattr(eng, k) for k in SPEC_COUNTERS}


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


async def _sequential(eng):
    out = []
    out.append(await eng.generate(JSON_LOOP + "solo", max_tokens=60))
    out.append(await eng.chat("seq", JSON_LOOP + "first turn", max_tokens=24))
    out.append(await eng.chat("seq", '{"tool": "search"} again', max_tokens=24))
    out.append(await eng.generate("repeat repeat repeat repeat", max_tokens=40))
    return [r["tokens"] for r in out]


@pytest.mark.parametrize("arena", ["dense", "paged"])
def test_sequential_greedy_tokens_and_counters_match_jax(engines, arena):
    """Sequential greedy traffic (the first test on fresh engines): the
    port's tokens equal the JAX engine's and the port's with speculation
    off, and the speculation counters equal the JAX engine's."""
    jeng, teng = (engines.j, engines.t) if arena == "dense" else (engines.jp, engines.tp)
    jb, tb = _counters(jeng), _counters(teng)
    want = run(_sequential(jeng))
    got = run(_sequential(teng))
    assert got == want
    if arena == "dense":
        assert got == run(_sequential(engines.off))
    jd, td = _delta(_counters(jeng), jb), _delta(_counters(teng), tb)
    assert td == jd
    assert td["spec_rounds"] > 0 and td["spec_accepted"] > 0
    m = teng.metrics()
    assert m["speculative"] is True and m["spec_acceptance_rate"] is not None
    assert set(m["spec_verify_hist"]) <= {"2", "4", "8"} and m["spec_verify_hist"]
    assert teng.worker_errors == 0, teng.last_worker_error


@pytest.mark.parametrize("arena", ["dense", "paged"])
def test_greedy_lane_beside_a_temperature_lane(engines, arena):
    jeng, teng = (engines.j, engines.t) if arena == "dense" else (engines.jp, engines.tp)

    async def mixed(eng):
        g, t = await asyncio.gather(
            eng.generate(JSON_LOOP + "mixed", max_tokens=48),
            eng.generate("noise lane " * 3, max_tokens=48, temperature=1.0),
        )
        return g["tokens"], t["completion_tokens"]

    got, n = run(mixed(teng))
    want, _ = run(mixed(jeng))
    assert got == want and n == 48
    if arena == "dense":
        assert got == run(mixed(engines.off))[0]


def test_junk_drafter_forces_rejections_and_tokens_stay_identical(engines):
    teng = engines.t
    teng._spec_draft = lambda slot, gamma: [3, 5]  # junk: ~always rejected
    try:
        before = _counters(teng)

        async def turns(eng):
            r1 = await eng.chat("junk", '{"t": "s", "q": 1}\n' * 3 + "turn one", max_tokens=40)
            r2 = await eng.chat("junk", "turn two continues the session", max_tokens=24)
            return r1["tokens"], r2["tokens"]

        got = run(turns(teng))
        d = _delta(_counters(teng), before)
    finally:
        del teng._spec_draft
    assert got == run(turns(engines.off))
    assert d["spec_drafted"] > 0 and d["spec_rejected"] > 0, d


def test_acceptance_ema_collapses_on_rejecting_traffic(engines):
    teng = engines.t
    teng._spec_draft = lambda slot, gamma: [3, 5]
    try:
        rounds = teng.spec_rounds
        r = run(teng.generate("repeat repeat repeat repeat repeat repeat", max_tokens=120))
        ema = min(teng.metrics()["spec_slot_acceptance"])
    finally:
        del teng._spec_draft
    assert r["completion_tokens"] == 120
    # the EMA fell under the floor: gamma 0, the plain ladder took over
    assert ema < SPEC_EMA_FLOOR
    assert teng.spec_rounds - rounds < 50


def test_stale_kv_beyond_live_length_is_masked(engines):
    """Garbage written over every arena slot at or above a slot's live
    length (what rejected drafts leave) changes no later token."""
    teng, off = engines.t, engines.off

    async def turn1(eng):
        return (await eng.chat("rw", JSON_LOOP + "first turn", max_tokens=24))["tokens"]

    async def turn2(eng):
        return (await eng.chat("rw", "second turn continues", max_tokens=24))["tokens"]

    assert run(turn1(teng)) == run(turn1(off))
    idx = teng.sessions["rw"]
    pos = teng.slots[idx].position
    teng.cache.k[:, idx, pos:] = 1e3
    teng.cache.v[:, idx, pos:] = -1e3
    assert run(turn2(teng)) == run(turn2(off))


def test_paged_rewind_truncates_page_tails_and_keeps_shared_pages(engines):
    """Paged: a session that forked a cached prefix (pages mapped shared)
    then speculates with rejections: rejected-draft pages return to the
    pool (pages_truncated_total), the mapped prefix pages stay, and a
    truncation below the fork point never drops them."""
    teng = engines.tp
    prefix = "shared persona header for the rewind test " * 2  # 85 tokens
    run(teng.generate(prefix + "register", max_tokens=2))  # registers 32, 64
    teng._spec_draft = lambda slot, gamma: [3, 5]
    try:
        truncated = teng.pages_truncated
        run(teng.chat("rw-paged", prefix + "then speculate", max_tokens=60))
    finally:
        del teng._spec_draft
    sess = teng.paged_sessions["rw-paged"]
    assert sess.shared == 64 // PAGED["page_size"]
    shared = list(sess.pages[: sess.shared])
    assert teng.pages_truncated > truncated
    assert sess.position > 64 and len(sess.pages) == -(-sess.position // PAGED["page_size"])
    # a rewind below the fork point keeps the mapped pages
    with teng._page_lock:
        pos = sess.position
        sess.position = 3
        teng._truncate_session_pages(sess)
        assert sess.pages == shared
        sess.position = min(pos, 64)
    assert all(teng._page_refs[p] >= 2 for p in shared)  # the session and the cache


def test_drafter_matches_jax_on_random_streams():
    rng = np.random.default_rng(0)
    for _ in range(200):
        n = int(rng.integers(0, 80))
        seq = rng.integers(0, 6, n).tolist()  # small alphabet: n-grams repeat
        want = int(rng.integers(1, 9))
        assert TEngine._spec_lookup(list(seq), want) == JEngine._spec_lookup(list(seq), want)
        hist, gen = seq[: n // 2], seq[n // 2 :]
        slot = SimpleNamespace(spec_hist=hist, request=SimpleNamespace(generated=gen))
        got = TEngine._spec_draft(SimpleNamespace(_spec_lookup=TEngine._spec_lookup), slot, want)
        ref = JEngine._spec_draft(SimpleNamespace(_spec_lookup=JEngine._spec_lookup), slot, want)
        assert got == ref
