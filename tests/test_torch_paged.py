"""The port's paged KV path against the JAX package on the CPU.

Ops (``gather_pages``, ``scatter_paged_kv``, ``paged_cache_attention``),
the paged kernels' plain versions (against the JAX fused paged kernels in
interpret mode, on the fixtures of tests/test_pallas_attention.py:
scrambled table, a page shared by two lanes, ragged offsets, several q
blocks), the paged ``forward`` and the paged engine (greedy tokens
identical to the JAX paged engine on ``tiny`` in f32 with the same
weights), residency beyond ``max_batch``, pool exhaustion as a typed 429,
and the serve layer's mapping of it. Tolerances as the repo's kernel tests:
f32 rtol = atol = 2e-5, bf16 3e-2. Engines are built once per module.
"""

import asyncio
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentainer_tpu.engine.llm import LLMEngine as JEngine
from agentainer_tpu.engine.tokenizer import ByteTokenizer as JTok
from agentainer_tpu.models import configs as jconfigs
from agentainer_tpu.models import llama as jl
from agentainer_tpu.ops import attention as jatt
from agentainer_tpu.ops import pallas_attention as jpa
from agentainer_tpu_torch.engine.llm import EngineOverloaded, PagePoolExhausted, PrefillFailed
from agentainer_tpu_torch.engine.llm import LLMEngine as TEngine
from agentainer_tpu_torch.engine.llm import _as_prefill_failure
from agentainer_tpu_torch.engine.llm_serve import LLMServeApp
from agentainer_tpu_torch.engine.tokenizer import ByteTokenizer as TTok
from agentainer_tpu_torch.models import configs as tconfigs
from agentainer_tpu_torch.models import llama as tl
from agentainer_tpu_torch.models.convert import params_from_numpy
from agentainer_tpu_torch.ops import attention as tatt
from agentainer_tpu_torch.ops import cuda_attention as tca

F32, BF16 = 2e-5, 3e-2


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


def _paged_fixture(seed, b, nb, ps, kv, hd, n_pages):
    """tests/test_pallas_attention.py's fixture, drawn with numpy: scrambled
    page ids, and lanes 0 and 1 SHARE page 7."""
    rng = np.random.default_rng(seed)
    pool_k, pool_v = _rand(rng, n_pages, ps, kv, hd), _rand(rng, n_pages, ps, kv, hd)
    table = rng.permutation(n_pages)[: b * nb].astype(np.int32).reshape(b, nb)
    if b >= 2:
        table[0, 0] = 7
        table[1, 0] = 7
    return pool_k, pool_v, table


# -- ops ------------------------------------------------------------------


def test_gather_pages_matches_jax():
    pool_k, pool_v, table = _paged_fixture(0, 3, 4, 16, 2, 8, 16)
    got = tatt.gather_pages(_t(pool_k), _t(pool_v), _t(table))
    want = jatt.gather_pages(*(jnp.asarray(x) for x in (pool_k, pool_v, table)))
    for g, w in zip(got, want):
        assert g.shape == (3, 64, 2, 8)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_scatter_paged_kv_matches_jax_including_the_clamp():
    """Lane 1's last position lies past the logical arena (S = 64): it
    clamps to slot S - 1, the lane's scratch slot, as JAX's does."""
    pool_k, pool_v, table = _paged_fixture(1, 2, 4, 16, 2, 8, 16)
    rng = np.random.default_rng(2)
    k_new, v_new = _rand(rng, 2, 3, 2, 8), _rand(rng, 2, 3, 2, 8)
    pos = np.array([[0, 17, 40], [61, 62, 70]], np.int32)
    tk, tv = _t(pool_k), _t(pool_v)
    assert tatt.scatter_paged_kv(tk, tv, _t(k_new), _t(v_new), _t(table), _t(pos)) is None
    jk, jv = jatt.scatter_paged_kv(
        *(jnp.asarray(x) for x in (pool_k, pool_v, k_new, v_new, table, pos))
    )
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tk[table[1, 3], 15].numpy(), k_new[1, 2])


@pytest.mark.parametrize("t", [1, 6])
def test_paged_cache_attention_dispatch_on_cpu(t):
    """CPU tensors gather and take the plain reference path, decode
    (T == 1) and prefill alike, and agree with the JAX dispatch."""
    b, heads, kv, hd, ps, nb = 3, 4, 2, 128, 16, 4
    pool_k, pool_v, table = _paged_fixture(3, b, nb, ps, kv, hd, 16)
    rng = np.random.default_rng(4)
    q = _rand(rng, b, t, heads, hd)
    pos = (np.array([0, 21, 40], np.int32)[:, None] + np.arange(t, dtype=np.int32)).astype(np.int32)
    launches = [fn.launches for fn in (tca.fused_paged_flash_prefill, tca.fused_paged_flash_decode)]
    got = tatt.paged_cache_attention(_t(q), _t(pool_k), _t(pool_v), _t(table), _t(pos))
    assert [fn.launches for fn in (tca.fused_paged_flash_prefill, tca.fused_paged_flash_decode)] == launches
    want = jatt.paged_cache_attention(
        *(jnp.asarray(x) for x in (q, pool_k, pool_v, table, pos)), use_pallas=False
    )
    _close(got, want, F32)


# -- the kernels' plain versions against the JAX fused paged kernels -------


def test_paged_decode_plain_matches_jax():
    b, heads, kv, hd, ps, nb = 3, 4, 2, 128, 16, 4
    pool_k, pool_v, table = _paged_fixture(5, b, nb, ps, kv, hd, 16)
    q = _rand(np.random.default_rng(6), b, heads, hd)
    pos = np.array([0, 30, 63], np.int32)
    got = tca.paged_flash_decode_plain(_t(q), _t(pool_k), _t(pool_v), _t(table), _t(pos))
    want = jpa.fused_paged_flash_decode(q, pool_k, pool_v, jnp.asarray(table), pos, interpret=True)
    _close(got, want, F32)
    # the wrapper runs the plain version on a CPU tensor
    got = tca.fused_paged_flash_decode(_t(q), _t(pool_k), _t(pool_v), _t(table), _t(pos))
    _close(got, want, F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_prefill_plain_ragged_matches_jax(dtype):
    """Chunked prefill at per-lane offsets: each lane attends its own pages
    at its own positions."""
    b, t, heads, kv, hd, ps, nb = 3, 16, 4, 2, 128, 16, 4
    pool_k, pool_v, table = _paged_fixture(7, b, nb, ps, kv, hd, 16)
    q = _rand(np.random.default_rng(8), b, t, heads, hd)
    pos = (np.array([0, 21, 48], np.int32)[:, None] + np.arange(t, dtype=np.int32)).astype(np.int32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = tca.fused_paged_flash_prefill(
        *(_t(x).to(tdt) for x in (q, pool_k, pool_v)), _t(table), _t(pos)
    )
    assert got.dtype == tdt
    want = jpa.fused_paged_flash_prefill(
        *(jnp.asarray(x, jdt) for x in (q, pool_k, pool_v)), jnp.asarray(table), pos,
        interpret=True,
    )
    _close(got, want.astype(jnp.float32), F32 if dtype == "float32" else BF16)


def test_paged_prefill_plain_multiple_q_blocks():
    b, t, heads, kv, hd, ps, nb = 1, 160, 4, 4, 128, 32, 8
    pool_k, pool_v, table = _paged_fixture(9, b, nb, ps, kv, hd, 8)
    q = _rand(np.random.default_rng(10), b, t, heads, hd)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t))
    got = tca.paged_flash_prefill_plain(_t(q), _t(pool_k), _t(pool_v), _t(table), _t(pos))
    want = jpa.fused_paged_flash_prefill(
        q, pool_k, pool_v, jnp.asarray(table), jnp.asarray(pos), block_q=64, interpret=True
    )
    _close(got, want, F32)


def test_paged_decode_plain_bf16():
    b, heads, kv, hd, ps, nb = 2, 4, 2, 128, 16, 4
    pool_k, pool_v, table = _paged_fixture(11, b, nb, ps, kv, hd, 16)
    q = _rand(np.random.default_rng(12), b, heads, hd)
    pos = np.array([15, 62], np.int32)
    got = tca.paged_flash_decode_plain(
        *(_t(x).to(torch.bfloat16) for x in (q, pool_k, pool_v)), _t(table), _t(pos)
    )
    assert got.dtype == torch.bfloat16
    want = jpa.fused_paged_flash_decode(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, pool_k, pool_v)), jnp.asarray(table), pos,
        interpret=True,
    )
    _close(got, want.astype(jnp.float32), BF16)


@pytest.mark.parametrize("page_size", [16, 64, 12, 8])
def test_paged_wrappers_take_any_page_size(page_size):
    """The fused paged kernels look the page up per load, so no page-size
    gate sends a page size that is not a multiple of 8 elsewhere:
    ``paged_cache_attention`` and both wrappers agree with JAX's gathered
    reference at every page size, decode and prefill alike."""
    b, heads, kv, hd, nb = 2, 4, 2, 128, 3
    pool_k, pool_v, table = _paged_fixture(13, b, nb, page_size, kv, hd, 8)
    rng = np.random.default_rng(14)
    q = _rand(rng, b, 5, heads, hd)
    pos = (np.array([0, 10], np.int32)[:, None] + np.arange(5, dtype=np.int32)).astype(np.int32)
    args = (_t(pool_k), _t(pool_v), _t(table))
    want = {
        t: jatt.paged_cache_attention(
            *(jnp.asarray(x) for x in (q[:, :t], pool_k, pool_v, table, pos[:, -t:])),
            use_pallas=False,
        )
        for t in (5, 1)
    }
    for t in (5, 1):
        _close(tatt.paged_cache_attention(_t(q[:, :t]), *args, _t(pos[:, -t:])), want[t], F32)
    _close(tca.fused_paged_flash_prefill(_t(q), *args, _t(pos)), want[5], F32)
    _close(tca.fused_paged_flash_decode(_t(q[:, 0]), *args, _t(pos[:, -1])), want[1][:, 0], F32)


def test_paged_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU launches the kernel or raises; it is
    never sent to the plain version (a meta tensor is neither)."""
    q = torch.empty(1, 8, 4, 128, device="meta")
    pool = torch.empty(4, 16, 2, 128, device="meta")
    table = torch.empty(1, 2, dtype=torch.int32, device="meta")
    pos = torch.empty(1, 8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tca.fused_paged_flash_prefill(q, pool, pool, table, pos)
    with pytest.raises(ValueError):
        tca.fused_paged_flash_decode(q[:, 0], pool, pool, table, pos[:, 0])


# -- model ----------------------------------------------------------------

HD128 = dict(
    name="test-hd128", vocab_size=300, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
    ffn_dim=512, max_seq_len=256, rope_theta=10_000.0,
)


@pytest.mark.parametrize("name", ["tiny", "hd128"])
def test_paged_forward_matches_jax_and_the_dense_forward(name):
    """A ragged prefill chunk then one decode step through a scrambled table:
    logits within 2e-5 of the JAX paged forward, and torch.equal to the
    port's own dense forward, since the gathered view is the dense arena."""
    if name == "tiny":
        jcfg, tcfg = jconfigs.get_config("tiny"), tconfigs.get_config("tiny")
    else:
        jcfg, tcfg = jconfigs.ModelConfig(**HD128), tconfigs.ModelConfig(**HD128)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    b, t, ps, nb, n_pages = 2, 10, 16, 3, 8
    rng = np.random.default_rng(15)
    toks = rng.integers(0, jcfg.vocab_size, (b, t)).astype(np.int32)
    pos = (np.array([0, 30], np.int32)[:, None] + np.arange(t, dtype=np.int32)).astype(np.int32)
    table = rng.permutation(n_pages)[: b * nb].astype(np.int32).reshape(b, nb)
    dec, dpos = toks[:, -1:], pos[:, -1:] + 1
    dpos[1] = 20  # lane 1 decodes below its padded chunk

    jc = jl.PagedKVCache.create(jcfg, n_pages, ps, dtype=jnp.float32)
    jt = jnp.asarray(table)
    want_pre, jc = jl.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos), jc, block_table=jt)
    want_dec, jc = jl.forward(jp, jcfg, jnp.asarray(dec), jnp.asarray(dpos), jc, block_table=jt)

    tc = tl.PagedKVCache.create(tcfg, n_pages, ps, dtype=torch.float32)
    dense = tl.KVCache.create(tcfg, b, nb * ps, dtype=torch.float32)
    with torch.no_grad():
        got_pre = tl.forward(tp, tcfg, _t(toks).long(), _t(pos), tc, block_table=_t(table))
        got_dec = tl.forward(tp, tcfg, _t(dec).long(), _t(dpos), tc, block_table=_t(table))
        dense_pre = tl.forward(tp, tcfg, _t(toks).long(), _t(pos), dense)
        dense_dec = tl.forward(tp, tcfg, _t(dec).long(), _t(dpos), dense)
    np.testing.assert_allclose(got_pre.numpy(), np.asarray(want_pre), rtol=F32, atol=F32)
    np.testing.assert_allclose(got_dec.numpy(), np.asarray(want_dec), rtol=F32, atol=F32)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=F32, atol=F32)
    assert torch.equal(got_pre, dense_pre) and torch.equal(got_dec, dense_dec)


# -- engine ---------------------------------------------------------------

# tests/test_paged_kv.py's shapes
SHAPE = dict(max_batch=4, max_seq=128, decode_chunk=4, prefill_chunk=32)
PAGED = dict(paged_kv=True, page_size=32, kv_pages=64)


@pytest.fixture(scope="module")
def engines():
    jcfg, tcfg = jconfigs.get_config("tiny"), tconfigs.get_config("tiny")
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    jeng = JEngine(
        jcfg, jp, JTok(jcfg.vocab_size), **SHAPE, **PAGED,
        prefix_cache=False, speculative=False, deadlines=False,
    )
    teng = TEngine(
        tcfg, tp, TTok(tcfg.vocab_size), **SHAPE, **PAGED,
        prefix_cache=False, speculative=False, deadlines=False, device="cpu",
    )
    teng.warmup()
    yield jeng, teng
    jeng.shutdown()
    teng.shutdown()


def run(coro):
    return asyncio.run(coro)


def test_paged_solo_request_matches(engines):
    jeng, teng = engines
    prompt = "a solo generation prompt with some words"
    want = run(jeng.generate(prompt, max_tokens=24, ignore_eos=True))
    got = run(teng.generate(prompt, max_tokens=24, ignore_eos=True))
    assert got["tokens"] == want["tokens"] and got["text"] == want["text"]
    assert teng.paged and teng.metrics()["paged_kv"] is True


def test_paged_concurrent_batch_matches(engines):
    jeng, teng = engines
    reqs = [("msg zero", 3), ("a second message", 9), ("third", 6), ("and the fourth one", 12)]

    async def batch(eng):
        return await asyncio.gather(
            *(eng.generate(p, max_tokens=m, ignore_eos=True) for p, m in reqs)
        )

    got = [r["tokens"] for r in run(batch(teng))]
    assert got == [r["tokens"] for r in run(batch(jeng))]
    assert [len(t) for t in got] == [m for _, m in reqs]
    # sessionless generations free their pages at finish
    assert teng.metrics()["kv_pages_used"] == sum(len(s.pages) for s in teng.paged_sessions.values())


def test_paged_two_turn_session_matches(engines):
    """Between turns the session holds pages and no lane."""
    jeng, teng = engines

    async def turns(eng):
        a = await eng.chat("sess", "first turn of a session", max_tokens=12, ignore_eos=True)
        b = await eng.chat("sess", "second turn continues", max_tokens=12, ignore_eos=True)
        return a["tokens"], b["tokens"]

    assert run(turns(teng)) == run(turns(jeng))
    sess, ref = teng.paged_sessions["sess"], jeng.paged_sessions["sess"]
    assert sess.lane is None and sess.pages and sess.position > 0
    assert (sess.position, len(sess.pages)) == (ref.position, len(ref.pages))
    assert teng.sessions["sess"] == -1
    assert all((teng._bt[i] == teng._scratch_page(i)).all() for i in range(teng.max_batch))


def test_paged_prompt_longer_than_prefill_chunk_matches(engines):
    jeng, teng = engines
    prompt = "a long prompt that spans several prefill chunks " * 2  # 97 tokens
    assert len(teng.tokenizer.encode(prompt)) > 2 * SHAPE["prefill_chunk"]
    want = run(jeng.generate(prompt, max_tokens=8, ignore_eos=True))
    got = run(teng.generate(prompt, max_tokens=8, ignore_eos=True))
    assert got["tokens"] == want["tokens"]
    assert teng.worker_errors == 0


def test_paged_metrics_keys_match_the_reference(engines):
    jeng, teng = engines
    ref = jeng._paged_metrics()
    got = teng.metrics()
    assert set(ref) <= set(got)
    assert got["kv_pages_quarantined"] == 0 and got["kv_pages_total"] == PAGED["kv_pages"]
    assert set(got["kernel_launches"]) == {
        "flash_prefill", "flash_decode", "fused_paged_flash_prefill", "fused_paged_flash_decode",
        "w8a16_matmul", "w8a16_grouped_matmul",
    }


def _port(**opts) -> TEngine:
    o = {"device": "cpu", **SHAPE, "paged_kv": True, "page_size": 32}
    o.update(opts)
    return TEngine.create("tiny", options=o)


def test_residency_beyond_max_batch_and_eviction_readmission():
    """(tests/test_paged_kv.py) A dense-equivalent pool holds >= 4x max_batch
    short sessions with no eviction; overflowing it evicts idle residents
    LRU-first, and an evicted session re-admits cold and serves."""
    paged = _port(max_batch=2, max_seq=256)
    try:

        async def sessions(prefix, n, message, max_tokens):
            for i in range(n):
                await paged.chat(f"{prefix}{i}", message, max_tokens=max_tokens, ignore_eos=True)

        run(sessions("c", 8, "hi", 8))
        m = paged.metrics()
        assert m["resident_sessions"] >= 4 * paged.max_batch, m
        assert paged.session_evictions == 0 and "c0" in paged.sessions
        run(sessions("big", 4, "x " * 100, 24))
        assert paged.session_evictions > 0
        assert paged.metrics()["resident_sessions"] < 12
        assert "c0" not in paged.paged_sessions  # least recently used went first
        r = run(paged.chat("c0", "hello again", max_tokens=8, ignore_eos=True))
        assert len(r["tokens"]) == 8
        assert paged.worker_errors == 0, paged.last_worker_error
    finally:
        paged.shutdown()


def test_pool_exhaustion_is_a_typed_429_and_rolls_back():
    """(tests/test_paged_kv.py, without the failpoint half) A pool too small
    for a generation fails THAT request with PagePoolExhausted and keeps
    serving; a resident session that trips it is rolled back, not dropped."""
    eng = _port(max_batch=2, max_seq=128, kv_pages=2)
    try:
        with pytest.raises(PagePoolExhausted):
            run(eng.generate("grow past the pool " * 3, max_tokens=80, ignore_eos=True))
        assert eng.metrics()["page_exhausted_total"] >= 1
        assert len(run(eng.generate("small", max_tokens=8, ignore_eos=True))["tokens"]) == 8

        async def keep_flow():
            await eng.chat("keep", "hello", max_tokens=8, ignore_eos=True)
            sess = eng.paged_sessions["keep"]
            pos, pend, pages = sess.position, sess.pending_token, list(sess.pages)
            with pytest.raises(EngineOverloaded):
                await eng.chat("keep", "go long", max_tokens=80, ignore_eos=True)
            sess = eng.paged_sessions["keep"]
            assert (sess.position, sess.pending_token, sess.pages) == (pos, pend, pages)
            assert sess.lane is None and eng.sessions["keep"] == -1
            return await eng.chat("keep", "short again", max_tokens=8, ignore_eos=True)

        assert len(run(keep_flow())["tokens"]) == 8
        assert eng.worker_errors == 0, eng.last_worker_error
    finally:
        eng.shutdown()


def test_clear_sessions_racing_the_worker_keeps_every_page_accounted_for():
    """clear_sessions runs on API threads while the worker allocates, binds
    and frees pages: with more clearing threads than cores and a short
    switch interval, every data page ends up either free or owned by exactly
    one resident session, once."""
    eng = _port(max_batch=4, max_seq=128, kv_pages=24)
    stop = threading.Event()

    def clearer():
        while not stop.is_set():
            eng.clear_sessions("")

    threads = [threading.Thread(target=clearer, daemon=True) for _ in range(os.cpu_count() + 1)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()

        async def traffic():
            for turn in range(2):
                rs = await asyncio.wait_for(asyncio.gather(*(
                    eng.chat(f"r{i}", f"turn {turn} of session {i}", max_tokens=6, ignore_eos=True)
                    for i in range(12)
                )), timeout=120)
                assert all(len(r["tokens"]) == 6 for r in rs)

        run(traffic())
    finally:
        stop.set()
        sys.setswitchinterval(interval)
        for th in threads:
            th.join(timeout=10)
    try:
        assert not any(th.is_alive() for th in threads)
        owned = [p for s in eng.paged_sessions.values() for p in s.pages]
        assert len(set(owned)) == len(owned)
        assert len(set(eng._page_free)) == len(eng._page_free)
        assert sorted(owned + eng._page_free) == list(range(eng._data_pages))
        assert all(eng._page_refs[p] == 1 for p in owned)
        assert all(eng._page_refs[p] == 0 for p in eng._page_free)
        assert all(s.lane is None for s in eng.paged_sessions.values())
        assert eng.worker_errors == 0, eng.last_worker_error
    finally:
        eng.shutdown()


def test_overload_errors_pass_through_typed():
    e = PagePoolExhausted(3, 1)
    assert isinstance(e, EngineOverloaded) and (e.depth, e.watermark) == (3, 1)
    assert _as_prefill_failure(e) is e
    assert isinstance(_as_prefill_failure(ValueError("x")), PrefillFailed)


# -- serve ----------------------------------------------------------------


def test_chat_maps_pool_exhaustion_to_429_and_metrics_carry_pages(engines):
    jeng, _ = engines
    app = LLMServeApp(env={
        "AGENTAINER_AGENT_ID": "agent-p",
        "AGENTAINER_MODEL_CONFIG": "tiny",
        "AGENTAINER_MODEL_OPTIONS": json.dumps({
            "device": "cpu", "max_batch": 2, "max_seq": 128, "decode_chunk": 4,
            "prefill_chunk": 32, "paged_kv": True, "page_size": 32, "kv_pages": 2,
        }),
    })
    th = threading.Thread(target=lambda: asyncio.run(app.run("127.0.0.1", 0)), daemon=True)
    th.start()
    try:
        deadline = time.monotonic() + 120
        while (app.port is None or app.engine is None) and not app.engine_error:
            assert time.monotonic() < deadline, "server did not come up"
            time.sleep(0.05)
        assert not app.engine_error

        def post(body):
            req = urllib.request.Request(
                f"http://127.0.0.1:{app.port}/chat", data=json.dumps(body).encode(), method="POST"
            )
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    return resp.status, resp.headers, json.loads(resp.read())
            except urllib.error.HTTPError as e:
                return e.code, e.headers, json.loads(e.read())

        status, _, doc = post({"message": "hi", "session": "s", "max_tokens": 4})
        assert status == 200 and doc["usage"]["completion_tokens"] == 4
        status, headers, doc = post(
            {"message": "go long", "session": "s", "max_tokens": 80, "ignore_eos": True}
        )
        assert status == 429, doc
        assert headers["Retry-After"] == "1"
        assert set(doc) == {"error", "depth", "watermark"} and "exhausted" in doc["error"]
        assert app.unhandled_errors == 0

        with urllib.request.urlopen(f"http://127.0.0.1:{app.port}/metrics", timeout=60) as resp:
            m = json.loads(resp.read())
        assert set(jeng._paged_metrics()) <= set(m)
        assert m["paged_kv"] is True and m["kv_pages_used"] >= 1 and m["page_exhausted_total"] == 1
        assert m["resident_sessions"] == 1  # session s survived its 429
        assert len(m["kernel_launches"]) == 6
    finally:
        app.stop()
        th.join(timeout=30)
    assert not th.is_alive()
