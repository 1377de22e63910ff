"""The port's prefix cache against the JAX package on the CPU.

Engines serve ``tiny`` in f32 with the same weights and the reference's
defaults (prefix cache, speculation and deadlines on), over the dense arena
and the paged one (page size 64). Held here (tests/test_prefix_cache.py's
and tests/test_paged_kv.py's bars):

- on the same sequential traffic the port's greedy tokens equal the JAX
  engine's, and the port's own with the prefix cache off; ``prefix_hits``,
  ``prefix_tokens_saved`` and ``prefix_arena_entries`` equal the JAX
  engine's;
- LRU eviction under a small ``_prefix_budget``, counted as JAX counts it;
- an evicted session re-admits through a prefix hit; the serve layer's
  persona prewarm registers the persona, so fresh sessions fork it;
- paged: a page-aligned level maps pages with no copy, bucket 32 under page
  size 64 copies its tail page, and after the sessions and the cache are
  cleared every refcount is 0 and every page is free;
- ``_rolling_hashes`` equals the JAX function.

Engines are built once per module; each test uses its own session names
and counts in deltas.
"""

import asyncio
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from agentainer_tpu.engine.llm import LLMEngine as JEngine
from agentainer_tpu.engine.tokenizer import ByteTokenizer as JTok
from agentainer_tpu.models import configs as jconfigs
from agentainer_tpu.models.llama import init_params as jinit
from agentainer_tpu_torch.engine.llm import LLMEngine as TEngine
from agentainer_tpu_torch.engine.llm_serve import LLMServeApp, Request
from agentainer_tpu_torch.engine.tokenizer import ByteTokenizer as TTok
from agentainer_tpu_torch.models import configs as tconfigs
from agentainer_tpu_torch.models.convert import params_from_numpy

SHAPE = dict(max_batch=4, max_seq=256, decode_chunk=8, prefill_chunk=32)
PAGED = dict(paged_kv=True, page_size=64)
# ~90 tokens with the byte tokenizer: spans buckets 32 and 64
SHARED = "the quick brown fox jumps over the lazy dog " * 2
PREFIX_COUNTERS = ("prefix_hits", "prefix_misses", "prefix_tokens_saved")


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
        off=port(prefix_cache=False),
    )
    yield e
    for eng in vars(e).values():
        eng.shutdown()


def run(coro):
    return asyncio.run(coro)


def _counters(eng):
    m = eng.metrics()
    return {k: m[k] for k in (*PREFIX_COUNTERS, "prefix_arena_entries", "prefix_evictions_total")}


async def _sequential(eng):
    out = [
        await eng.generate(SHARED + "alpha", max_tokens=8),
        await eng.generate(SHARED + "beta", max_tokens=8),  # hit at 64
        await eng.chat("pfx-s", SHARED + "gamma", max_tokens=8),  # hit at 64
        await eng.chat("pfx-s", "a second turn continues", max_tokens=8),  # continuing
        await eng.generate(SHARED[:31] + " shares only bucket 32", max_tokens=8),  # hit at 32
    ]
    return [r["tokens"] for r in out]


@pytest.mark.parametrize("arena", ["dense", "paged"])
def test_sequential_tokens_and_counters_match_jax(engines, arena):
    jeng, teng = (engines.j, engines.t) if arena == "dense" else (engines.jp, engines.tp)
    want = run(_sequential(jeng))
    got = run(_sequential(teng))
    assert got == want
    if arena == "dense":
        assert got == run(_sequential(engines.off))
        assert engines.off.metrics()["prefix_hits"] == 0
    c = _counters(teng)
    assert c == _counters(jeng)
    assert c["prefix_hits"] == 3 and c["prefix_tokens_saved"] == 64 + 64 + 32
    m = teng.metrics()
    assert m["prefix_cache"] is True
    assert 0 < m["prefix_arena_bytes"] <= m["prefix_arena_capacity_bytes"]
    if arena == "paged":
        assert m["kv_pages_prefix_pinned"] > 0 and m["prefix_pages_shared_total"] > 0
        assert m["kv_pages_prefix_pinned"] == engines.jp.metrics()["kv_pages_prefix_pinned"]


def test_evicted_session_readmits_via_prefix_hit(engines):
    teng = engines.t

    async def drive():
        await teng.chat("victim", SHARED + "turn one", max_tokens=2)
        for i in range(teng.max_batch):  # every slot, then the LRU goes
            await teng.chat(f"other-{i}", f"unrelated words {i}", max_tokens=2)
        assert "victim" not in teng.sessions and teng.session_evictions >= 1
        hits, saved = teng.prefix_hits, teng.prefix_tokens_saved
        await teng.chat("victim", SHARED + "turn two", max_tokens=2)
        assert teng.prefix_hits == hits + 1
        assert teng.prefix_tokens_saved - saved == 64

    run(drive())
    assert teng.metrics()["session_eviction_idle_s_p50"] is not None


def test_persona_prewarm_registers_the_persona(engines):
    """The serve layer's load-time prewarm puts the persona in the cache, so
    the first fresh session already forks it."""
    teng = engines.t
    app = LLMServeApp(env={"AGENTAINER_AGENT_ID": "pw", "AGENTAINER_SYSTEM_PROMPT": SHARED})
    run(app._prewarm_prefix(teng))
    app.engine = teng
    assert app.prefix_prewarms == 1
    hits = teng.prefix_hits
    for s in ("p1", "p2"):
        resp = run(app.h_chat(Request("POST", "/chat", {}, json.dumps(
            {"message": f"hello from {s}", "session": s, "max_tokens": 2}
        ).encode())))
        assert resp.status == 200
    assert teng.prefix_hits == hits + 2
    assert run(app.h_metrics(Request("GET", "/metrics", {}, b""))).doc["prefix_prewarms"] == 1


def test_lru_eviction_under_a_small_budget_matches_jax(engines):
    """A budget of 2.5 bucket-32 entries: distinct prompts evict LRU, the
    arena never exceeds the budget, and JAX evicts the same count."""
    jeng, teng = engines.j, engines.t
    one = 32 * teng._kv_bytes_per_pos
    saved = (jeng._prefix_budget, teng._prefix_budget)
    jeng._prefix_budget = teng._prefix_budget = int(2.5 * one)
    # both arenas start empty: other tests of the module drive the port alone
    for eng in (jeng, teng):
        while eng._prefix_entries:
            eng._prefix_evict_lru()
    try:
        before = (_counters(jeng), _counters(teng))

        async def drive(eng):
            for i in range(4):
                await eng.generate(f"distinct prefix number {i} " * 4, max_tokens=2)

        run(drive(jeng))
        run(drive(teng))
        m = teng.metrics()
        assert m["prefix_arena_bytes"] <= teng._prefix_budget
        assert m["prefix_evictions_total"] > before[1]["prefix_evictions_total"]
        assert m["prefix_eviction_idle_s_p50"] is not None
        assert _counters(teng)["prefix_evictions_total"] - before[1]["prefix_evictions_total"] == (
            _counters(jeng)["prefix_evictions_total"] - before[0]["prefix_evictions_total"]
        )
        assert _counters(teng)["prefix_arena_entries"] == _counters(jeng)["prefix_arena_entries"]
    finally:
        jeng._prefix_budget, teng._prefix_budget = saved


def test_paged_mapping_is_zero_copy_aligned_and_copies_the_tail_at_bucket_32(engines):
    teng = engines.tp
    run(teng.generate("paged persona text for the mapping test " * 3, max_tokens=2))
    copies = []
    real_copy = teng._copy_page
    teng._copy_page = lambda src, dst: (copies.append((src, dst)), real_copy(src, dst))
    try:
        # level 64 is one whole page: mapped, nothing copied
        run(teng.chat("map-64", "paged persona text for the mapping test " * 3, max_tokens=2))
        s64 = teng.paged_sessions["map-64"]
        assert copies == [] and s64.shared == 1
        entry = next(e for (b, _), e in teng._prefix_entries.items()
                     if b == 64 and e.tokens == tuple(teng.tokenizer.encode(
                         "paged persona text for the mapping test " * 3)[:64]))
        assert s64.pages[0] == entry.pages[0] and entry.tail_page is None
        # level 32 under page size 64: the tail page is copied (copy on write)
        run(teng.chat("map-32", "paged persona text for the mapping test"[:31] + " diverges here",
                      max_tokens=2))
        s32 = teng.paged_sessions["map-32"]
        assert len(copies) == 1 and s32.shared == 0 and s32.pages[0] == copies[0][1]
    finally:
        del teng._copy_page


def test_paged_refcounts_return_to_zero(engines):
    """Register → map → tail copy → evict pins → sessions freed: every
    refcount back to 0, every data page on the free list."""
    teng = engines.tp
    teng.clear_sessions()
    while teng._prefix_entries:
        teng._prefix_evict_lru()
    assert teng.metrics()["kv_pages_prefix_pinned"] == 0
    assert int(teng._page_refs[: teng._data_pages].sum()) == 0
    assert sorted(teng._page_free) == list(range(teng._data_pages))
    assert teng.worker_errors == 0, teng.last_worker_error


def test_rolling_hashes_match_jax():
    rng = np.random.default_rng(0)
    for n in (0, 1, 31, 32, 33, 64, 100, 513, 1100):
        toks = rng.integers(0, 128256, n).tolist()
        assert TEngine._rolling_hashes(toks) == JEngine._rolling_hashes(toks)
