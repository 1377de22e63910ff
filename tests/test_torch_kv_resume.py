"""KV crash-resume in the port, and across frameworks, on the CPU.

The equivalence bar of tests/test_kv_resume.py: snapshot a session's KV,
destroy the engine, restore into another engine — the continuation is
token-identical to an uninterrupted conversation. Held here:

- the port's counterparts of tests/test_kv_resume.py's four tests, of
  tests/test_paged_kv.py::test_snapshot_restore_round_trip_across_layouts
  and of tests/test_speculative.py::
  test_rejected_drafts_then_restore_round_trip_matches_plain;
- cross-framework, both ways: a JAX engine's blob restores into the port
  (dense and paged), whose next turn equals the JAX engine's uninterrupted
  turn, and a port blob restores into the JAX engine the same way; both
  engines hold the same weights (the JAX ``init_params`` tree);
- a snapshot asked for mid-generation parks and is staged at the finish; a
  second one bounces, and five bounces end in ``SnapshotDeferred``;
- a restore writes the arena in place, binds no lane (paged), refuses a
  busy session and an exhausted pool with False.

Greedy tokens exact, ``tiny`` in f32.
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
from agentainer_tpu_torch.engine.checkpoint import deserialize_kv_slot
from agentainer_tpu_torch.engine.llm import LLMEngine, PagePoolExhausted, SnapshotDeferred
from agentainer_tpu_torch.engine.tokenizer import ByteTokenizer as TTok
from agentainer_tpu_torch.models import configs as tconfigs
from agentainer_tpu_torch.models.convert import params_from_numpy

OPTS = {"max_batch": 2, "max_seq": 128, "decode_chunk": 4, "device": "cpu"}


def run(coro):
    return asyncio.run(coro)


def _mk(**opts) -> LLMEngine:
    return LLMEngine.create("tiny", options=dict(OPTS, **opts))


async def _until_decoding(eng, session: str) -> None:
    """Wait until ``session``'s request is on a decoding lane."""
    while not any(s.decoding and s.session == session for s in eng.slots):
        await asyncio.sleep(0.001)


# -- tests/test_kv_resume.py's four -------------------------------------------


def test_snapshot_restore_resumes_identically():
    async def uninterrupted():
        eng = _mk()
        a = await eng.chat("s", "turn one", max_tokens=5)
        b = await eng.chat("s", "turn two", max_tokens=5)
        eng.shutdown()
        return a, b

    async def interrupted():
        eng1 = _mk()
        a = await eng1.chat("s", "turn one", max_tokens=5)
        blob = await eng1.snapshot_session("s")
        assert blob is not None
        eng1.shutdown()  # the crash

        eng2 = _mk()
        assert not eng2.has_session("s")
        assert await eng2.restore_session("s", blob) is True
        assert eng2.has_session("s")
        b = await eng2.chat("s", "turn two", max_tokens=5)
        eng2.shutdown()
        return a, b, blob

    ref_a, ref_b = run(uninterrupted())
    got_a, got_b, blob = run(interrupted())
    assert got_a["tokens"] == ref_a["tokens"]
    assert got_b["tokens"] == ref_b["tokens"]  # the resume is exact
    k, v, header = deserialize_kv_slot(blob)
    assert header["position"] == k.shape[1]
    assert header["session"] == "s"
    assert k.shape[1] < OPTS["max_seq"]


def test_restore_rejects_oversized_snapshot():
    async def body():
        eng = _mk()
        await eng.chat("s", "hello", max_tokens=4)
        blob = await eng.snapshot_session("s")
        eng.shutdown()
        small = _mk(max_seq=8)
        try:
            _, _, header = deserialize_kv_slot(blob)
            assert header["position"] >= 7
            assert await small.restore_session("s", blob) is False
            assert not small.has_session("s")
        finally:
            small.shutdown()

    run(body())


def test_snapshot_unknown_session_is_none():
    eng = _mk()
    try:
        assert run(eng.snapshot_session("nope")) is None
    finally:
        eng.shutdown()


def test_snapshot_beyond_1024_ships_the_full_prefix():
    """A session past the 1024 prefill bucket snapshots its whole prefix
    (the port slices ``[:position]``; the reference's power-of-two bucket
    grows up to max_seq for the same reason)."""
    eng = _mk(max_seq=4096, prefill_chunk=512)
    try:

        async def go():
            await eng.chat(session="lc", message="word " * 250, max_tokens=4)
            pos = eng.slots[eng.sessions["lc"]].position
            assert pos > 1024, pos
            blob = await eng.snapshot_session("lc")
            k, _, header = deserialize_kv_slot(blob)
            assert header["position"] == pos == k.shape[1]
            assert await eng.restore_session("lc2", blob) is True
            a = await eng.chat("lc", "and on", max_tokens=6)
            b = await eng.chat("lc2", "and on", max_tokens=6)
            assert a["tokens"] == b["tokens"]

        run(go())
    finally:
        eng.shutdown()


# -- tests/test_paged_kv.py's and tests/test_speculative.py's -----------------

PAGED_BASE = {"max_batch": 4, "max_seq": 128, "decode_chunk": 4, "prefill_chunk": 32, "speculative": False}


def test_snapshot_restore_round_trip_across_layouts():
    """Blobs staged from live pages restore into the paged engine and the
    dense one, and dense blobs into both; the continuation is
    token-identical in all six lanes; the paged restore binds no lane, and
    the two arenas' blobs carry the same payload."""
    paged = _mk(**PAGED_BASE, paged_kv=True, page_size=32)
    dense = _mk(**PAGED_BASE)
    try:

        async def drive():
            await paged.chat("snap", "some context worth keeping around", max_tokens=12)
            await dense.chat("snap", "some context worth keeping around", max_tokens=12)
            pb = await paged.snapshot_session("snap")
            db = await dense.snapshot_session("snap")
            assert pb and db
            assert await paged.restore_session("from-paged", pb)
            assert paged.paged_sessions["from-paged"].lane is None
            assert await paged.restore_session("from-dense", db)
            assert await dense.restore_session("from-paged", pb)
            assert await dense.restore_session("from-dense", db)
            outs = []
            for e, name in (
                (paged, "snap"), (paged, "from-paged"), (paged, "from-dense"),
                (dense, "snap"), (dense, "from-paged"), (dense, "from-dense"),
            ):
                outs.append((await e.chat(name, "continue the story", max_tokens=12))["tokens"])
            return pb, db, outs

        pb, db, outs = run(drive())
        assert all(o == outs[0] for o in outs), outs
        assert paged.paged_sessions["from-paged"].lane is None
        (pk, pv, ph), (dk, dv, dh) = deserialize_kv_slot(pb), deserialize_kv_slot(db)
        assert torch.equal(pk, dk) and torch.equal(pv, dv)
        assert ph["page_size"] == 32 and "page_size" not in dh
    finally:
        paged.shutdown()
        dense.shutdown()


def test_rejected_drafts_then_restore_round_trip_matches_plain():
    """After a generation with forced rejections (a junk drafter), the
    snapshot carries no stale draft: it restores into a never-speculating
    engine, whose continuation equals the plain engine's."""
    spec = _mk(max_batch=4, max_seq=256, decode_chunk=8, prefill_chunk=32)
    spec._spec_draft = lambda slot, gamma: [3, 5]  # junk: ~always rejected
    base = _mk(max_batch=4, max_seq=256, decode_chunk=8, prefill_chunk=32, speculative=False)
    try:

        async def turns(e):
            r1 = await e.chat("s", '{"t": "s", "q": 1}\n' * 3 + "turn one", max_tokens=40)
            blob = await e.snapshot_session("s")
            r2 = await e.chat("s", "turn two continues the session", max_tokens=24)
            return r1, blob, r2

        r1s, blob_s, r2s = run(turns(spec))
        r1b, _, r2b = run(turns(base))
        assert r1s["tokens"] == r1b["tokens"]
        assert spec.spec_drafted > 0 and spec.spec_rejected > 0, spec.metrics()
        assert r2s["tokens"] == r2b["tokens"]

        async def resume():
            assert await base.restore_session("r", blob_s)
            return await base.chat("r", "turn two continues the session", max_tokens=24)

        assert run(resume())["tokens"] == r2b["tokens"]
    finally:
        spec.shutdown()
        base.shutdown()


# -- the port's own: parked snapshots, the limiter, restore edges -------------


@pytest.mark.parametrize("paged", [False, True])
def test_parked_snapshot_is_staged_at_finish_and_a_second_defers(paged):
    eng = _mk(paged_kv=paged, page_size=32, max_seq=1024, speculative=False)
    eng.snapshot_min_gap_s = 0.001
    try:

        async def go():
            gen = asyncio.ensure_future(
                eng.chat("long", "keep going", max_tokens=400, ignore_eos=True)
            )
            await _until_decoding(eng, "long")
            parked = asyncio.ensure_future(eng.snapshot_session("long"))
            while "long" not in eng._snap_parked:
                await asyncio.sleep(0.001)
            with pytest.raises(SnapshotDeferred):
                await eng.snapshot_session("long")  # five bounces off the parked one
            assert not gen.done()
            reply = await gen
            blob = await parked
            quiet = await eng.snapshot_session("long")
            return reply, blob, quiet

        reply, blob, quiet = run(go())
        assert reply["completion_tokens"] == 400
        (k, v, h), (qk, qv, qh) = deserialize_kv_slot(blob), deserialize_kv_slot(quiet)
        assert h == qh and h["position"] > 400
        assert torch.equal(k, qk) and torch.equal(v, qv)
        assert eng.metrics()["kv_snapshots_total"] == 2
    finally:
        eng.shutdown()


def test_snapshot_limiter_bounces_a_busy_engine_until_overdue():
    """While another session decodes, a settled session's snapshot is
    rate-limited until its durability floor (``snapshot_force_s``) is due."""
    eng = _mk(speculative=False, max_seq=1024)
    eng.snapshot_min_gap_s = 0.001
    eng.snapshot_busy_gap_s = 0.001
    try:

        async def go():
            await eng.chat("quiet", "settled", max_tokens=3)
            gen = asyncio.ensure_future(eng.chat("busy", "go", max_tokens=400, ignore_eos=True))
            await _until_decoding(eng, "busy")
            with pytest.raises(SnapshotDeferred):
                await eng.snapshot_session("quiet")
            eng.snapshot_force_s = 0.0  # overdue now
            blob = await eng.snapshot_session("quiet")
            await gen
            return blob

        assert deserialize_kv_slot(run(go()))[2]["session"] == "quiet"
    finally:
        eng.shutdown()


@pytest.mark.parametrize("paged", [False, True])
def test_restore_writes_in_place_and_refuses_busy_or_full(paged):
    eng = _mk(paged_kv=paged, page_size=32, max_seq=256, speculative=False)
    try:
        store = (eng.cache.k, eng.cache.v) if paged else (eng.cache.k_store, eng.cache.v_store)
        ptrs = [t.data_ptr() for t in store]

        async def go():
            await eng.chat("a", "first session " * 4, max_tokens=8)
            blob = await eng.snapshot_session("a")
            assert await eng.restore_session("b", blob)
            # a busy session is never clobbered
            gen = asyncio.ensure_future(eng.chat("c", "busy", max_tokens=200, ignore_eos=True))
            await _until_decoding(eng, "c")
            busy = await eng.restore_session("c", blob)
            await gen
            return blob, busy

        blob, busy = run(go())
        assert busy is False
        assert [t.data_ptr() for t in store] == ptrs
        if paged:
            # a restored session holds pages and no lane; an exhausted pool
            # refuses the restore
            assert eng.paged_sessions["b"].lane is None

            def exhausted(n, pin=False):
                raise PagePoolExhausted(n, 0)

            eng._alloc_pages = exhausted
            assert run(eng.restore_session("x", blob)) is False
            assert not eng.has_session("x")
    finally:
        eng.shutdown()


# -- across frameworks ----------------------------------------------------------

X_SHAPE = dict(max_batch=2, max_seq=128, decode_chunk=4, prefill_chunk=32)
T1, T2 = "turn one of a conversation", "and turn two"


@pytest.fixture(scope="module")
def frameworks():
    """A JAX engine and a dense and a paged port engine on the same weights,
    the speculation and prefix cache off (the JAX engine then compiles
    little); the staging limiter spaced to nothing."""
    jcfg, tcfg = jconfigs.get_config("tiny"), tconfigs.get_config("tiny")
    jp = jinit(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    feats = dict(prefix_cache=False, speculative=False)
    jeng = JEngine(jcfg, jp, JTok(jcfg.vocab_size), **X_SHAPE, **feats)
    ports = {
        paged: LLMEngine(
            tcfg, tp, TTok(tcfg.vocab_size), **X_SHAPE, **feats, paged_kv=paged, page_size=32,
            device="cpu",
        )
        for paged in (False, True)
    }
    for e in (jeng, *ports.values()):
        e.snapshot_min_gap_s = 0.0
    yield jeng, ports
    jeng.shutdown()
    for e in ports.values():
        e.shutdown()


async def _turns(eng, session):
    a = await eng.chat(session, T1, max_tokens=7, ignore_eos=True)
    blob = await eng.snapshot_session(session)
    b = await eng.chat(session, T2, max_tokens=9, ignore_eos=True)
    return a["tokens"], blob, b["tokens"]


async def _resume(eng, session, blob):
    assert await eng.restore_session(session, blob) is True
    return (await eng.chat(session, T2, max_tokens=9, ignore_eos=True))["tokens"]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_a_jax_blob_resumes_in_the_port(frameworks, paged):
    jeng, ports = frameworks
    a, blob, b = run(_turns(jeng, f"j2t-{paged}"))
    assert run(_resume(ports[paged], f"from-jax-{paged}", blob)) == b


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_a_port_blob_resumes_in_jax(frameworks, paged):
    jeng, ports = frameworks
    a, blob, b = run(_turns(ports[paged], f"t2j-{paged}"))
    ja, _, jb = run(_turns(jeng, f"jax-ref-{paged}"))
    assert (a, b) == (ja, jb)  # the same weights decode the same turns
    assert run(_resume(jeng, f"from-port-{paged}", blob)) == b
