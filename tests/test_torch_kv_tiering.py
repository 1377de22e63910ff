"""The port's tiered KV hierarchy (device -> pinned host RAM) against the
JAX package's on the CPU.

Mirrors ``tests/test_kv_tiering.py`` (every test there has a counterpart
here under its name): both engines serve ``tiny`` in f32 with the SAME
weights and the reference's default features; a session parked off the
device and promoted back for its next turn continues with the greedy
tokens of the JAX engine's never-parked session — dense and paged, exact
and int8 host tiers. Around that: promotion overlaps admission, pool
pressure demotes instead of answering 429, reused pages cannot corrupt a
parked copy, and the ``engine.kv_demote``/``engine.kv_promote`` failpoints
(armed through the port's ``faults``) degrade as the reference's do. Beside
them: park blobs move both ways between the packages, and a quantized host
entry is bit-equal to the reference's ``quantize_kv_pages`` of the same KV.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from agentainer_tpu.engine import quant as jquant
from agentainer_tpu.engine.llm import LLMEngine as JEngine
from agentainer_tpu.engine.tokenizer import ByteTokenizer as JTok
from agentainer_tpu.models import configs as jconfigs
from agentainer_tpu.models.llama import init_params as jinit
from agentainer_tpu_torch import faults
from agentainer_tpu_torch.engine.llm import EngineOverloaded, TierPromoteFailed
from agentainer_tpu_torch.engine.llm import LLMEngine as TEngine
from agentainer_tpu_torch.engine.tokenizer import ByteTokenizer as TTok
from agentainer_tpu_torch.models import configs as tconfigs
from agentainer_tpu_torch.models.convert import params_from_numpy

OPTS_DENSE = {"max_batch": 2, "max_seq": 128, "decode_chunk": 4}
OPTS_PAGED = {
    "max_batch": 2,
    "max_seq": 128,
    "decode_chunk": 4,
    "paged_kv": True,
    "page_size": 16,
    "kv_pages": 16,
}


def run(coro):
    return asyncio.run(coro)


def _opts(paged: bool, quantized: bool) -> dict:
    return dict(OPTS_PAGED if paged else OPTS_DENSE, kv_tiering=True, tier_quantize=int(quantized))


@pytest.fixture(scope="module")
def weights():
    jcfg = jconfigs.get_config("tiny")
    jp = jinit(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def make(weights, side: str, opts: dict):
    jcfg, jp, tp = weights
    if side == "jax":
        return JEngine(jcfg, jp, JTok(jcfg.vocab_size), **opts)
    tcfg = tconfigs.get_config("tiny")
    return TEngine(tcfg, tp, TTok(tcfg.vocab_size), **opts, device="cpu")


@pytest.fixture(scope="module")
def control(weights):
    """The JAX engine's never-parked turns: (paged, prompts) -> tokens."""
    memo: dict = {}

    def get(paged: bool, turns: tuple, session_first: tuple = ()) -> list:
        key = (paged, turns, session_first)
        if key not in memo:

            async def body():
                eng = make(weights, "jax", dict(OPTS_PAGED if paged else OPTS_DENSE))
                try:
                    out = []
                    for sess, msg in turns:
                        out.append((await eng.chat(sess, msg, max_tokens=5))["tokens"])
                    return out
                finally:
                    eng.shutdown()

            memo[key] = run(body())
        return memo[key]

    return get


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm_all()


TWO_TURNS = (("s", "turn one"), ("s", "turn two"))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("quantized", [False, True], ids=["exact", "int8"])
def test_park_promote_roundtrip_is_token_identical(weights, control, paged, quantized):
    async def parked():
        eng = make(weights, "torch", _opts(paged, quantized))
        try:
            a = await eng.chat("s", "turn one", max_tokens=5)
            blob = await eng.park_session("s")
            assert blob is not None
            assert "s" not in eng.sessions
            assert eng.has_session("s")
            if quantized:
                assert eng.tier_quantized_pages > 0
            if paged:
                assert eng.metrics()["kv_pages_used"] == 0
            b = await eng.chat("s", "turn two", max_tokens=5)
            assert eng.tier_demotions_total >= 1
            assert eng.tier_promotions_total >= 1
            return [a["tokens"], b["tokens"]]
        finally:
            eng.shutdown()

    assert run(parked()) == control(paged, TWO_TURNS)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_promotion_overlaps_admission(weights, control, paged):
    async def body():
        eng = make(weights, "torch", _opts(paged, True))
        try:
            a = await eng.chat("s", "turn one", max_tokens=5)
            assert await eng.park_session("s") is not None
            assert await eng.prewarm_session("s") is True
            assert eng.tier_prewarm_hits_total == 1
            b = await eng.chat("s", "turn two", max_tokens=5)
            assert eng.tier_promotions_total == 1
            assert eng.tier_promote_overlap_ms_total > 0
            assert len(eng.tier_promote_overlap_ms_recent) == 1
            return [a["tokens"], b["tokens"]]
        finally:
            eng.shutdown()

    assert run(body()) == control(paged, TWO_TURNS)


def test_pool_pressure_demotes_instead_of_429(weights):
    opts = dict(_opts(True, True))
    opts.update({"max_seq": 64, "kv_pages": 6})

    async def body():
        eng = make(weights, "torch", opts)
        try:
            msg = "alpha alpha alpha alpha alpha alpha"
            await eng.chat("a", msg, max_tokens=6)
            await eng.chat("b", msg.replace("alpha", "bravo"), max_tokens=6)
            r = await eng.chat("c", msg.replace("alpha", "charl"), max_tokens=6)
            assert r["tokens"]
            assert eng.tier_pressure_demotions_total >= 1
            assert eng.session_evictions == 0  # nothing destroyed
            parked = [s for s in ("a", "b") if s not in eng.sessions]
            assert parked
            for s in parked:
                assert eng.has_session(s)
            # a demoted session's next turn promotes and serves
            r2 = await eng.chat(parked[0], " again", max_tokens=4)
            assert r2["tokens"] and eng.tier_promotions_total >= 1
        finally:
            eng.shutdown()

    run(body())


def test_reused_pages_cannot_corrupt_parked_copy(weights, control):
    turns = (("a", "turn one"), ("b", "filler filler filler"), ("a", "turn two"))

    async def raced():
        eng = make(weights, "torch", _opts(True, True))
        try:
            a1 = await eng.chat("a", "turn one", max_tokens=5)
            assert await eng.park_session("a") is not None
            b = await eng.chat("b", "filler filler filler", max_tokens=5)
            a2 = await eng.chat("a", "turn two", max_tokens=5)
            return [a1["tokens"], b["tokens"], a2["tokens"]]
        finally:
            eng.shutdown()

    assert run(raced()) == control(True, turns)


def test_kv_demote_failpoint_keeps_session_resident(weights):
    async def body():
        eng = make(weights, "torch", _opts(True, True))
        try:
            await eng.chat("s", "turn one", max_tokens=5)
            faults.arm("engine.kv_demote", error="RuntimeError", count=1)
            assert await eng.park_session("s") is None
            assert "s" in eng.sessions
            assert eng.tier_demote_failures_total == 1
            r = await eng.chat("s", "turn two", max_tokens=5)
            assert r["tokens"]
        finally:
            eng.shutdown()

    run(body())


def test_kv_promote_failpoint_is_typed_429_then_recovers(weights, control):
    async def body():
        eng = make(weights, "torch", _opts(True, True))
        try:
            a = await eng.chat("s", "turn one", max_tokens=5)
            assert await eng.park_session("s") is not None
            faults.arm("engine.kv_promote", error="RuntimeError", count=1)
            with pytest.raises(TierPromoteFailed) as ei:
                await eng.chat("s", "turn two", max_tokens=5)
            assert isinstance(ei.value, EngineOverloaded)
            assert eng.tier_promote_failures_total == 1
            assert eng.has_session("s")
            assert "s" not in eng.sessions
            b = await eng.chat("s", "turn two", max_tokens=5)
            return [a["tokens"], b["tokens"]]
        finally:
            eng.shutdown()

    assert run(body()) == control(True, TWO_TURNS)


def test_tier_metrics_surface(weights):
    async def body():
        eng = make(weights, "torch", _opts(True, True))
        try:
            await eng.chat("s", "turn one", max_tokens=5)
            await eng.park_session("s")
            m = eng.metrics()
            assert m["kv_tiering"] is True
            assert m["tier_host_sessions"] == 1
            assert m["tier_host_bytes"] > 0
            assert m["tier_quantized_pages"] > 0
            assert m["tier_demotions_total"] == 1
            await eng.chat("s", "turn two", max_tokens=5)
            m = eng.metrics()
            assert m["tier_host_sessions"] == 0
            assert m["tier_promotions_total"] == 1
            # the reference's gauges, under its names
            jm = make(weights, "jax", _opts(True, True))
            try:
                want = {k for k in jm.metrics() if k.startswith(("tier_", "kv_tiering"))}
            finally:
                jm.shutdown()
            assert want <= set(m)
        finally:
            eng.shutdown()

    run(body())


def test_tiering_off_is_inert(weights):
    async def body():
        eng = make(weights, "torch", dict(OPTS_PAGED))
        try:
            await eng.chat("s", "turn one", max_tokens=5)
            assert await eng.park_session("s") is None
            assert "s" in eng.sessions
            assert await eng.prewarm_session("s") is False
        finally:
            eng.shutdown()

    run(body())


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_park_blob_moves_both_ways(weights, control, paged):
    """The port's park blob restores in the JAX engine, and the JAX park
    blob in the port's: each continues the never-parked turn two."""
    opts = _opts(paged, False)

    async def park(side):
        eng = make(weights, side, opts)
        try:
            await eng.chat("s", "turn one", max_tokens=5)
            return await eng.park_session("s")
        finally:
            eng.shutdown()

    async def resume(side, blob):
        eng = make(weights, side, opts)
        try:
            assert await eng.restore_session("s", blob) is True
            return (await eng.chat("s", "turn two", max_tokens=5))["tokens"]
        finally:
            eng.shutdown()

    want = control(paged, TWO_TURNS)[1]
    assert run(resume("jax", run(park("torch")))) == want
    assert run(resume("torch", run(park("jax")))) == want


def test_quantized_host_entry_is_bit_equal_to_the_reference(weights):
    """The int8 host entry of a parked session is the reference's
    ``quantize_kv_pages`` of the same KV (the staged prefix), bit for
    bit, scales included."""
    from agentainer_tpu_torch.engine.checkpoint import deserialize_kv_slot

    async def body():
        eng = make(weights, "torch", _opts(True, True))
        try:
            await eng.chat("s", "a prompt that spans two pages", max_tokens=5)
            blob = await eng.park_session("s")
            return blob, eng._host_tier["s"], eng.page_size
        finally:
            eng.shutdown()

    blob, entry, page_size = run(body())
    k, v, header = deserialize_kv_slot(blob)
    assert entry.quantized and entry.position == header["position"] > page_size
    for got_q, got_s, exact in ((entry.k, entry.k_scale, k), (entry.v, entry.v_scale, v)):
        want_q, want_s = jquant.quantize_kv_pages(exact.numpy(), page_size)
        np.testing.assert_array_equal(got_q, want_q)
        np.testing.assert_array_equal(got_s, want_s)
