"""Serve-time sequence parallelism in the port, on the CPU, against the JAX
package (``tests/test_sp_decode_hlo.py``, ``tests/test_longcontext_serving.py``).

The JAX engines run on the virtual 8-device CPU mesh (``tests/conftest.py``);
the port's meshes hold every shard on ``cpu`` (``parallel/mesh.make_mesh(
devices=["cpu"] * n)``), built from the JAX engine's own weights
(``params_from_numpy``), in f32. Held:

- the kernels' ``lse`` entries (their plain versions here) against a direct
  f32 log-sum-exp, rows that see no slot included, and the rows bit-equal
  with and without it;
- the sp decode attention joined over two shards against the JAX package's
  unsharded ``attention_reference`` (f32, ``atol`` 1e-5, the reference's),
  and its collective shape: no all-gather as large as one shard's KV, one
  cross-shard reduction (``NoLargeAllGather``, ``HasCrossReduction`` read
  from ``parallel/collectives.record``, the reference's HLO contracts);
- a prefill chunk that straddles the shards' boundary: each shard writes
  its own slots and the joined rows equal the unsharded attention;
- the five engine cases of ``tests/test_longcontext_serving.py``: the arena
  sharded over the sequence, greedy tokens equal to the JAX sp=4 engine on
  ``tiny`` with a prompt past one shard, tp=2 × sp=2 against the JAX
  engine, the default context cap, a multi-turn session past a shard;
- a snapshot taken under sp restores into a one-device engine and into a
  pp=2 engine, and a one-device snapshot into sp, each continuing the
  uninterrupted session token for token;
- ``create``'s placement of sp beside tp/ep, as the reference's.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentainer_tpu.engine.llm import LLMEngine as JEngine
from agentainer_tpu.ops.attention import attention_reference as jattention, cache_mask as jcache_mask
from agentainer_tpu_torch.analysis.contracts import HasCrossReduction, NoLargeAllGather, check
from agentainer_tpu_torch.engine import llm as tllm
from agentainer_tpu_torch.engine.llm import LLMEngine as TEngine
from agentainer_tpu_torch.engine.tokenizer import ByteTokenizer as TTok
from agentainer_tpu_torch.models import configs as tconfigs
from agentainer_tpu_torch.models.convert import params_from_numpy
from agentainer_tpu_torch.models.llama import KVCache, MeshCache
from agentainer_tpu_torch.ops import cuda_attention as ca
from agentainer_tpu_torch.parallel.collectives import record
from agentainer_tpu_torch.parallel.flash_mesh import make_meshed_cache_attention
from agentainer_tpu_torch.parallel.mesh import make_mesh
from agentainer_tpu_torch.parallel.sharding import cache_spec, shard_tensor

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4, reason="needs the virtual multi-device mesh")

TCFG = tconfigs.get_config("tiny")
# > 64 tokens: crosses one shard's S/sp = 64 slots at max_seq 256, sp 4
LONG_PROMPT = " ".join(f"tok{i}" for i in range(150))
SHAPE = {"max_batch": 2, "max_seq": 256, "prefill_chunk": 32}


def run(coro):
    return asyncio.run(coro)


def _cpu_mesh(**axes):
    n = int(np.prod(list(axes.values())))
    return make_mesh(n, devices=["cpu"] * n, **axes)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


# ---------------------------------------------------------------------------
# the lse entries


def _direct_lse(q, k, pos):
    """f32 log-sum-exp of each row's scaled scores over the slots it sees,
    straight from the definition (``-inf`` where it sees none)."""
    b, t, h, hd = q.shape
    kv = k.shape[2]
    kr = k.repeat_interleave(h // kv, dim=2)  # [B, S, H, hd]
    s = torch.einsum("bthd,bshd->bths", q.double(), kr.double()) / hd**0.5
    visible = torch.arange(k.shape[1])[None, None, None, :] <= pos[:, :, None, None]
    return torch.logsumexp(torch.where(visible, s, torch.tensor(-np.inf, dtype=torch.float64)), dim=-1)


def test_lse_entries_equal_a_direct_logsumexp():
    g = torch.Generator().manual_seed(0)
    b, t, h, kv, s, hd = 3, 5, 4, 2, 40, 16
    q = torch.randn((b, t, h, hd), generator=g)
    k, v = (torch.randn((b, s, kv, hd), generator=g) for _ in range(2))
    # row 0 sees no slot at all, row 2 runs past the arena's end
    pos = torch.tensor([[-5], [3], [36]]) + torch.arange(t)[None]
    out, lse = ca.flash_prefill(q, k, v, pos, return_lse=True)
    want = _direct_lse(q, k, pos)
    seen = torch.isfinite(want)
    assert seen.sum() < want.numel()  # some rows see nothing
    torch.testing.assert_close(lse[seen].double(), want[seen], rtol=0, atol=2e-5)
    assert (lse[~seen] == ca.NEG_INF).all() and (out[~seen.any(-1)] == 0).all()
    assert lse.dtype == torch.float32 and lse.shape == (b, t, h)
    assert torch.equal(out, ca.flash_prefill(q, k, v, pos))  # the rows do not change
    dout, dlse = ca.flash_decode(q[:, 0], k, v, pos[:, 0], return_lse=True)
    torch.testing.assert_close(dlse[seen[:, 0]].double(), want[:, 0][seen[:, 0]], rtol=0, atol=2e-5)
    assert (dlse[~seen[:, 0]] == ca.NEG_INF).all()
    assert torch.equal(dout, ca.flash_decode(q[:, 0], k, v, pos[:, 0]))


# ---------------------------------------------------------------------------
# the sp attention (tests/test_sp_decode_hlo.py)

B, S, KV, G, HD = 2, 64, 2, 2, 16
H = KV * G
SHARD_ELEMS = B * S * KV * HD // 2  # one shard's KV


def _sp_attention(q, k, v, pos, sp, cache_len=S):
    """q/k/v/pos through the port's meshed attention over an sp mesh of
    CPU shards: k/v written as one step at ``pos`` into a cache of
    ``cache_len`` slots split over sp, then attended. Returns the joined
    rows of shard 0, the collective log and the mesh's cache."""
    mesh = _cpu_mesh(sp=sp)
    b, t = pos.shape
    cache = MeshCache.create(
        mesh, lambda d: KVCache.create(TCFG, b, cache_len // sp, torch.float32, d, n_kv_heads=k.shape[2])
    )
    attend = make_meshed_cache_attention(mesh=mesh)
    with record() as log:
        outs = attend([q] * sp, [(k, v)] * sp, cache.shards, 0, [pos] * sp)
    return outs, log, cache


def test_sp_decode_numerics_match_unsharded():
    """A decode row attending a 40-token context written over two shards
    (slots 0-31 and 32-63) equals the unsharded attention: the JAX
    package's ``attention_reference`` under ``cache_mask``."""
    rng = np.random.default_rng(0)
    k = rng.standard_normal((B, S, KV, HD), dtype=np.float32)
    v = rng.standard_normal((B, S, KV, HD), dtype=np.float32)
    q = rng.standard_normal((B, 1, H, HD), dtype=np.float32)
    want = jattention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      mask=jcache_mask(jnp.full((B, 1), 40, jnp.int32), S))
    mesh = _cpu_mesh(sp=2)
    cache = MeshCache.create(mesh, lambda d: KVCache.create(TCFG, B, S // 2, torch.float32, d, n_kv_heads=KV))
    cache.write_prefix(0, _t(k[0])[None].expand(TCFG.n_layers, -1, -1, -1), _t(v[0])[None].expand(
        TCFG.n_layers, -1, -1, -1))
    cache.write_prefix(1, _t(k[1])[None].expand(TCFG.n_layers, -1, -1, -1), _t(v[1])[None].expand(
        TCFG.n_layers, -1, -1, -1))
    # the step's own row (position 40) is written as it is in the arena
    pos = torch.full((B, 1), 40)
    step_k, step_v = _t(k[:, 40:41]), _t(v[:, 40:41])
    attend = make_meshed_cache_attention(mesh=mesh)
    with record() as log:
        outs = attend([_t(q)] * 2, [(step_k, step_v)] * 2, cache.shards, 0, [pos] * 2)
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(want), atol=1e-5)
    assert torch.equal(outs[0], outs[1])
    check(log, NoLargeAllGather(SHARD_ELEMS, what="the sp KV shard"), HasCrossReduction())
    assert [e["kind"] for e in log] == ["all_gather", "all_reduce"]
    assert log[0]["elements"] == B * 1 * H  # the rows' lse, not KV


def test_a_chunk_straddling_the_shards_writes_each_its_slots():
    """A 24-token prefill chunk at positions 20-43 over two 32-slot shards:
    slots 20-31 land in shard 0 and 32-43 in shard 1 (each shard's spare
    slot takes the other rows), the joined arena is the unsharded one, and
    every row's attention equals the unsharded kernels' plain version."""
    g = torch.Generator().manual_seed(1)
    t = 24
    q = torch.randn((B, t, H, HD), generator=g)
    k, v = (torch.randn((B, t, KV, HD), generator=g) for _ in range(2))
    pos = (torch.arange(t) + 20)[None].expand(B, t)
    outs, log, cache = _sp_attention(q, k, v, pos, sp=2)
    full = KVCache.create(TCFG, B, S, torch.float32, "cpu", n_kv_heads=KV)
    full.write(0, pos, k, v)
    want = ca.flash_prefill_plain(q, full.k[0], full.v[0], pos)
    torch.testing.assert_close(outs[0], want, rtol=0, atol=1e-5)
    for row in range(B):
        (jk, jv), = cache.read_prefix(row, 44)
        torch.testing.assert_close(jk, full.k_store[:, row, :44], rtol=0, atol=0)
        torch.testing.assert_close(jv, full.v_store[:, row, :44], rtol=0, atol=0)
    assert (cache.shards[0].k_store[0, :, 20:32] != 0).all()
    assert (cache.shards[1].k_store[0, :, :12] != 0).all() and (cache.shards[1].k_store[0, :, 12:32] == 0).all()
    check(log, NoLargeAllGather(SHARD_ELEMS), HasCrossReduction())


def test_a_row_that_sees_only_shard_zero_weighs_shard_one_zero():
    """Rows before slot S/sp see nothing of shard 1 (lse NEG_INF): the join
    is shard 0's rows, with no NaN, and a row that sees no slot at all
    (position -1, a parked scratch write) returns zeros."""
    g = torch.Generator().manual_seed(2)
    q = torch.randn((B, 1, H, HD), generator=g)
    k, v = (torch.randn((B, 1, KV, HD), generator=g) for _ in range(2))
    pos = torch.tensor([[5], [-1]])
    outs, _, cache = _sp_attention(q, k, v, pos, sp=2)
    assert torch.isfinite(outs[0]).all() and (outs[0][1] == 0).all()
    want = ca.flash_decode_plain(q[:1, 0], cache.shards[0].k[0][:1], cache.shards[0].v[0][:1], pos[:1, 0])
    torch.testing.assert_close(outs[0][:1, 0], want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# engines (tests/test_longcontext_serving.py)


@pytest.fixture(scope="module")
def jax_engines():
    made = {}

    def get(**axes):
        key = tuple(sorted(axes.items()))
        if key not in made:
            made[key] = JEngine.create("tiny", options={**SHAPE, **axes})
        return made[key]

    yield get
    for e in made.values():
        e.shutdown()


def _port(jeng, **axes):
    """A port engine over the JAX engine's weights on a CPU mesh of
    ``axes`` (one device without)."""
    params = params_from_numpy(jax.tree.map(np.asarray, jeng.params))
    mesh = _cpu_mesh(**axes) if axes else None
    eng = TEngine(TCFG, params, TTok(TCFG.vocab_size), **SHAPE, device="cpu", mesh=mesh)
    eng.warmup()
    return eng


def _gen(eng, prompt=LONG_PROMPT, n=6):
    return run(eng.generate(prompt, max_tokens=n))


def test_sp_engine_shards_arena_over_sequence():
    eng = TEngine.create("tiny", options={**SHAPE, "device": "cpu", "sp": 4})
    try:
        assert eng.sp == 4 and eng.tp == 1 and eng.mesh.size == 4
        # the slot axis of [L, B, S, KV, hd] is the split one: each shard
        # holds S/4 slots (and its spare one)
        assert [c.max_seq for c in eng.cache.shards] == [eng.max_seq // 4] * 4
        assert eng.params[0]["layers"]["wq"] is eng.params[3]["layers"]["wq"]  # replicated, one copy
        m = eng.metrics()
        assert (m["sp"], m["tp"], m["pp"]) == (4, 1, 1)
        assert _gen(eng)["completion_tokens"] == 6
    finally:
        eng.shutdown()


def test_sp_matches_single_device_beyond_one_shard(jax_engines):
    """A prompt past one shard's 64 slots decodes to the JAX sp=4 engine's
    greedy tokens, and to the port's unsharded engine's."""
    jeng = jax_engines(sp=4)
    t4, t1 = _port(jeng, sp=4), _port(jeng)
    try:
        want = _gen(jeng)["tokens"]
        assert len(want) == 6
        assert _gen(t4)["tokens"] == want
        assert _gen(t1)["tokens"] == want
        assert t4.worker_errors == 0, t4.last_worker_error
        # each shard's arena is the unsharded arena's slice under the
        # reference's cache_specs(sp=True): its quarter of every row's slots
        for sh, c in enumerate(t4.cache.shards):
            for got, full in ((c.k, t1.cache.k), (c.v, t1.cache.v)):
                torch.testing.assert_close(got, shard_tensor(full, cache_spec(sp=True), t4.mesh, sh),
                                           rtol=0, atol=1e-5)
    finally:
        t4.shutdown()
        t1.shutdown()


def test_sp_composes_with_tp(jax_engines):
    """tp=2 × sp=2: heads and slots split together; tokens unchanged."""
    jeng = jax_engines(tp=2, sp=2)
    eng = _port(jeng, tp=2, sp=2)
    try:
        assert (eng.tp, eng.sp) == (2, 2) and eng.mesh.size == 4
        assert [tuple(c.k_store.shape[2:4]) for c in eng.cache.shards] == [(129, 1)] * 4  # S/2 + spare, KV/2
        assert _gen(eng)["tokens"] == _gen(jeng)["tokens"]
        # the features of the reference's defaults took effect on the mesh
        persona = "You are a careful on-call assistant. Answer briefly. "
        for p in (persona + "what failed?", persona + "and now?", '{"tool": "search"}\n' * 6):
            run(eng.generate(p, max_tokens=12, ignore_eos=True))
        m = eng.metrics()
        assert m["prefix_hits"] > 0 and m["spec_rounds"] > 0
    finally:
        eng.shutdown()


def test_sp_raises_default_context_cap():
    e = TEngine.create("tiny", options={"device": "cpu", "sp": 4, "max_batch": 2, "prefill_chunk": 32})
    try:
        assert e.max_seq == min(TCFG.max_seq_len, 2048 * 4)
    finally:
        e.shutdown()
    cfg = tconfigs.get_config("llama3-8b")
    assert min(cfg.max_seq_len, 2048 * 2) == 4096  # llama3-8b at sp=2: 4096 slots, 2048 a shard


def test_sp_session_multiturn_context_survives(jax_engines):
    """Multi-turn chat on an sp engine past a shard: the JAX sp=4 engine's
    two turns."""
    jeng = jax_engines(sp=4)
    eng = _port(jeng, sp=4)

    def turn(e, session, message):
        return run(e.chat(session=session, message=message, max_tokens=4))["tokens"]

    try:
        got = [turn(eng, "s", LONG_PROMPT)]
        slot = eng.slots[eng.sessions["s"]]
        assert slot.position > eng.max_seq // 4  # the context crossed a shard
        got.append(turn(eng, "s", "and then"))
        assert got == [turn(jeng, "sp-turns", LONG_PROMPT), turn(jeng, "sp-turns", "and then")]
    finally:
        eng.shutdown()


def test_sp_snapshot_crosses_to_one_device_and_to_pp(jax_engines):
    """Turn one on an sp=2 engine past its first shard, its snapshot
    restored into a one-device engine and into a pp=2 one, turn two there;
    a one-device snapshot restored into sp=2: each the uninterrupted
    session's two turns."""
    jeng = jax_engines(sp=4)
    src_sp, dst_sp, one, pp = (_port(jeng, **axes) for axes in ({"sp": 2}, {"sp": 2}, {}, {"pp": 2}))
    for e in (src_sp, one):
        e.snapshot_min_gap_s = 0

    async def resumed(src, dst, session):
        a = await src.chat(session, LONG_PROMPT, max_tokens=5, ignore_eos=True)
        blob = await src.snapshot_session(session)
        assert await dst.restore_session(session, blob) is True
        b = await dst.chat(session, "turn two", max_tokens=6, ignore_eos=True)
        return a["tokens"], b["tokens"]

    async def uninterrupted(e):
        a = await e.chat("u", LONG_PROMPT, max_tokens=5, ignore_eos=True)
        b = await e.chat("u", "turn two", max_tokens=6, ignore_eos=True)
        return a["tokens"], b["tokens"]

    try:
        want = run(uninterrupted(one))
        assert run(resumed(src_sp, one, "a")) == want
        assert run(resumed(src_sp, pp, "b")) == want
        assert run(resumed(one, dst_sp, "c")) == want
    finally:
        for e in (src_sp, dst_sp, one, pp):
            e.shutdown()


@pytest.mark.parametrize("options,want", [
    ({"sp": 4}, (1, 1, 4)),
    ({"tp": 2, "sp": 2}, (2, 1, 2)),
    ({"sp": 2, "chips": [0, 1, 2, 3]}, (2, 1, 2)),  # sp reserved first, tp spans the rest
    ({"sp": 8, "chips": [0, 1]}, (1, 1, 2)),  # narrowed to the assignment
])
def test_sp_placement_equals_the_reference(options, want):
    """``_placement`` against the split the JAX package's ``create`` makes
    (``agentainer_tpu/engine/llm.py:1184-1216``) on tiny (2 kv heads)."""
    tp, ep, sp, pp, devices = tllm._placement(TCFG, {"device": "cpu", **options}, options.get("chips", []))
    assert (tp, ep, sp) == want and pp == 1 and devices == [torch.device("cpu")] * (tp * ep * sp)
    jeng = JEngine.create("tiny", options={**SHAPE, **options, "skip_warmup": True})
    try:
        assert (jeng.tp, jeng.ep, jeng.sp) == want
    finally:
        jeng.shutdown()
