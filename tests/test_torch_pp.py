"""Serve-time pipeline parallelism in the port, on the CPU, against the JAX
package (``tests/test_serve_pp.py``, ``tests/test_sharded_init.py``'s pp
cases).

The JAX engines run on the virtual 8-device CPU mesh (``tests/conftest.py``);
the port's pp=2 engine holds its two stages on ``cpu``, built from the JAX
engine's own weights (``params_from_numpy``) or from one HuggingFace
directory (the port reads HF directories where the reference's test writes
orbax), in f32. Held:

- the weights, the arena and the vocab matrices staged, one half a stage;
- greedy tokens equal to the JAX pp=2 engine's over two turns (and to the
  port's one-device engine's);
- the pp forward's logits equal the unsharded forward's bit for bit, with
  pp - 1 handoffs, one embedding all-reduce, one broadcast of the last
  hidden state and one logits all-gather in its collective log;
- ``create``'s refusals, with the reference's messages;
- random init into the stages; an HF checkpoint loaded into the stages
  serving the JAX pp=2 engine's tokens from the same directory;
- a pp snapshot restored into a one-device engine, and back.
"""

import asyncio

import jax
import numpy as np
import pytest
import torch

from agentainer_tpu.engine.llm import LLMEngine as JEngine
from agentainer_tpu_torch.engine.llm import LLMEngine as TEngine
from agentainer_tpu_torch.engine.tokenizer import ByteTokenizer as TTok
from agentainer_tpu_torch.models import configs as tconfigs
from agentainer_tpu_torch.models.convert import params_from_numpy
from agentainer_tpu_torch.models.llama import KVCache, MeshCache, forward, init_params
from agentainer_tpu_torch.parallel.collectives import record
from agentainer_tpu_torch.parallel.mesh import make_mesh
from agentainer_tpu_torch.parallel.sharding import pipeline_cache_spec, shard_params, shard_tensor

from tests.test_torch_hf_convert import write_hf

pytestmark = pytest.mark.skipif(len(jax.devices()) < 2, reason="needs the virtual multi-device mesh")

TCFG = tconfigs.get_config("tiny")
SHAPE = {"max_batch": 2, "max_seq": 128}


def run(coro):
    return asyncio.run(coro)


def _pp_mesh(pp=2):
    return make_mesh(pp, pp=pp, devices=["cpu"] * pp)


async def _two_turns(eng, session="s"):
    r1 = await eng.chat(session=session, message="the quick brown fox", max_tokens=6)
    r2 = await eng.chat(session=session, message="jumps over", max_tokens=6)
    return r1["tokens"], r2["tokens"]


@pytest.fixture(scope="module")
def jax_pp():
    eng = JEngine.create("tiny", options={"pp": 2, **SHAPE})
    yield eng
    eng.shutdown()


def _port(jeng, pp: int):
    params = params_from_numpy(jax.tree.map(np.asarray, jeng.params))
    eng = TEngine(TCFG, params, TTok(TCFG.vocab_size), **SHAPE, device="cpu",
                  mesh=_pp_mesh(pp) if pp > 1 else None)
    eng.warmup()
    return eng


def test_pp_engine_stages_weights_and_cache(jax_pp):
    eng = TEngine.create("tiny", options={"device": "cpu", "pp": 2, **SHAPE})
    try:
        assert eng.pp == 2 and len(eng.params) == 2
        half = TCFG.n_layers // 2
        assert [p["layers"]["wq"].shape[0] for p in eng.params] == [half] * 2
        assert isinstance(eng.cache, MeshCache)
        assert [c.k_store.shape[0] for c in eng.cache.shards] == [half] * 2
        # vocab matrices stage-owned, not replicated
        assert [p["embed"].shape[0] for p in eng.params] == [TCFG.vocab_size // 2] * 2
        assert [p["lm_head"].shape[1] for p in eng.params] == [TCFG.vocab_size // 2] * 2
        m, want = eng.metrics(), jax_pp.metrics()
        assert (m["pp"], m["tp"], m["sp"]) == (jax_pp.pp, want["tp"], want["sp"]) == (2, 1, 1)
        assert m["param_hbm_bytes"] == want["param_hbm_bytes"]
        assert m["kv_arena_bytes"] == want["kv_arena_bytes"]
        # the reference counts chips; the port counts the distinct devices
        # its shards sit on (both stages share the CPU here)
        assert want["n_chips"] == 2 and m["n_chips"] == 1
        assert m["paged_kv"] is False
    finally:
        eng.shutdown()


def test_pp_engine_matches_single_chip_greedy(jax_pp):
    t2, t1 = _port(jax_pp, 2), _port(jax_pp, 1)
    try:
        want = run(_two_turns(jax_pp, "ref"))
        assert run(_two_turns(t2)) == want
        assert run(_two_turns(t1)) == want
        assert t2.worker_errors == 0, t2.last_worker_error
        # each stage's arena is the unsharded arena's layers under the
        # reference's P("pp", None, None, None, None), bit for bit
        for stage, c in enumerate(t2.cache.shards):
            assert torch.equal(c.k_store, shard_tensor(t1.cache.k_store, pipeline_cache_spec(), t2.mesh, stage))
            assert torch.equal(c.v_store, shard_tensor(t1.cache.v_store, pipeline_cache_spec(), t2.mesh, stage))
    finally:
        t2.shutdown()
        t1.shutdown()


def test_pp_forward_logits_equal_the_unsharded_bit_for_bit():
    """Each stage runs the unsharded forward's per-layer ops in the same
    order, and the embedding's all-reduce adds zeros: the logits are the
    same bits, over a prefill chunk and a decode step."""
    cfg = TCFG
    params = init_params(cfg, torch.Generator().manual_seed(3), dtype=torch.float32)
    mesh = _pp_mesh()
    shards = shard_params(params, mesh)
    full = KVCache.create(cfg, 2, 64, torch.float32, "cpu")
    staged = MeshCache.create(mesh, lambda d: KVCache.create(cfg, 2, 64, torch.float32, d, n_layers=1))
    toks = torch.randint(0, cfg.vocab_size, (2, 20), generator=torch.Generator().manual_seed(4))
    pos = torch.arange(20)[None].expand(2, 20)
    with record() as log:
        got = forward(shards, cfg, toks, pos, staged, mesh=mesh)
    assert torch.equal(got, forward(params, cfg, toks, pos, full))
    assert [e["kind"] for e in log] == ["all_reduce", "handoff", "broadcast", "all_gather"]
    nxt = got[:, -1:].argmax(-1)
    with record() as log:
        got = forward(shards, cfg, nxt, pos[:, -1:] + 1, staged, mesh=mesh, last_index=torch.zeros(2))
    assert torch.equal(got, forward(params, cfg, nxt, pos[:, -1:] + 1, full, last_index=torch.zeros(2)))
    assert len(log) == 4
    (k, v), = staged.read_prefix(1, 21)
    assert torch.equal(k, full.k_store[:, 1, :21]) and torch.equal(v, full.v_store[:, 1, :21])


@pytest.mark.parametrize("options,match", [
    ({"pp": 2, "tp": 2}, "compose"),
    ({"pp": 2, "sp": 2}, "compose"),
    ({"pp": 2, "quant": "int8"}, "quantized"),
    ({"pp": 2, "routed": True}, "routed MoE"),
    ({"pp": 4}, "must divide n_layers=2"),
])
def test_pp_rejects_composition_and_quant(options, match):
    """The reference's refusals (``agentainer_tpu/engine/llm.py:1117-1131``)
    and its messages; its own test asserts the first and the third."""
    with pytest.raises(ValueError, match=match):
        TEngine.create("tiny", options={"device": "cpu", **options})
    if match in ("compose", "quantized"):
        with pytest.raises(ValueError, match=match):
            JEngine.create("tiny", options={**options, "skip_warmup": True})


def test_pp_pins_the_dense_arena_and_the_unfused_loop():
    eng = TEngine.create("tiny", options={"device": "cpu", "pp": 2, "paged_kv": True, "fused_decode": True,
                                          **SHAPE})
    try:
        assert eng.paged is False and eng.fused_decode is False
        assert run(eng.generate("pinned", max_tokens=4))["completion_tokens"] == 4
    finally:
        eng.shutdown()


def _stage_bytes(eng) -> list[int]:
    def walk(tree):
        return sum(walk(v) if isinstance(v, dict) else v.numel() * v.element_size() for v in tree.values())

    return [walk(p) for p in eng.params]


def test_pp_random_init_allocates_into_stages():
    eng = TEngine.create("tiny", options={"device": "cpu", "pp": 2, **SHAPE})
    try:
        total = eng.param_hbm_bytes
        per = _stage_bytes(eng)
        assert len(per) == 2 and sum(per) <= total + 4 * TCFG.dim  # final_norm: one copy a stage
        for nbytes in per:
            assert nbytes < 0.6 * total, (per, total)
    finally:
        eng.shutdown()


def test_pp_engine_loads_checkpoint(tmp_path):
    """A pp=2 engine deployed from an HF directory serves the same tokens as
    the one-device engine from it and as the JAX pp=2 engine from it."""
    write_hf(tmp_path, TCFG, seed=7)
    opts = {"max_batch": 2, "max_seq": 128}
    jeng = JEngine.create("", checkpoint=str(tmp_path), options={**opts, "pp": 2})
    e1 = TEngine.create("", checkpoint=str(tmp_path), options={**opts, "device": "cpu"})
    e2 = TEngine.create("", checkpoint=str(tmp_path), options={**opts, "device": "cpu", "pp": 2})
    try:
        async def go(e):
            r = await e.chat(session="s", message="the quick brown fox", max_tokens=8)
            return r["tokens"]

        want = run(go(jeng))
        assert run(go(e1)) == want and run(go(e2)) == want
        assert [p["layers"]["wq"].shape[0] for p in e2.params] == [e2.cfg.n_layers // 2] * 2
        assert torch.equal(torch.cat([p["layers"]["wq"] for p in e2.params]), e1.params["layers"]["wq"])
    finally:
        jeng.shutdown()
        e1.shutdown()
        e2.shutdown()


def test_pp_snapshot_restores_into_one_device_and_back(jax_pp):
    src2, dst2, src1, dst1 = (_port(jax_pp, pp) for pp in (2, 2, 1, 1))
    for e in (src2, src1):
        e.snapshot_min_gap_s = 0

    async def resumed(src, dst, session):
        a = await src.chat(session, "turn one of a session", max_tokens=6, ignore_eos=True)
        blob = await src.snapshot_session(session)
        assert await dst.restore_session(session, blob) is True
        b = await dst.chat(session, "turn two", max_tokens=8, ignore_eos=True)
        return a["tokens"], b["tokens"]

    async def uninterrupted():
        a = await jax_pp.chat("snap-ref", "turn one of a session", max_tokens=6, ignore_eos=True)
        b = await jax_pp.chat("snap-ref", "turn two", max_tokens=8, ignore_eos=True)
        return a["tokens"], b["tokens"]

    try:
        want = run(uninterrupted())
        assert run(resumed(src2, dst1, "a")) == want
        assert run(resumed(src1, dst2, "b")) == want
        assert run(resumed(src2, dst2, "c")) == want
    finally:
        for e in (src2, dst2, src1, dst1):
            e.shutdown()
