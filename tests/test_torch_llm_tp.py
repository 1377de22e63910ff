"""Serve-time tensor parallelism in the port's engine, on the CPU, against
the JAX package's meshed engine (``tests/test_llm_tp.py``,
``tests/test_quant.py``'s tp cases, ``tests/test_sharded_init.py``).

The JAX engines run on the virtual 8-device CPU mesh (``tests/conftest.py``);
the port's tp=2 engine holds its two shards on ``cpu``
(``parallel/mesh.make_mesh(devices=["cpu", "cpu"])``), built from the JAX
engine's own weights (``params_from_numpy``), in f32, with the reference's
default features on (prefix cache, speculation, deadlines). Held:

- greedy tokens of the port at tp=2 equal the JAX tp=2 engine's for the
  dense arena and int8 weights (the combinations the JAX package's own
  tests run on XLA:CPU) and the port's tp=1 engine's for dense, paged,
  int8 and the fused loop (the JAX package's tests run no paged or fused
  engine at tp=2, so those are held to the port's unsharded engine, which
  the port's other tests hold to the JAX engine);
- speculation and the prefix cache take effect on the meshed engine;
- a tp=2 snapshot restored into tp=2 and into tp=1 continues the session
  token for token, and a tp=1 snapshot restores into tp=2;
- ``create``'s placement: chips spanned by tp, tp narrowed to an
  assignment, pp beside tp still raising, the card's visible devices
  (monkeypatched: this machine has none);
- the params and the arena are cut per shard, and ``/metrics`` reports
  tp (``test_tp_engine_shards_params_and_cache``'s port).
"""

import asyncio

import jax
import numpy as np
import pytest
import torch

from agentainer_tpu.engine.llm import LLMEngine as JEngine
from agentainer_tpu_torch.engine import llm as tllm
from agentainer_tpu_torch.engine.llm import LLMEngine as TEngine
from agentainer_tpu_torch.engine.tokenizer import ByteTokenizer as TTok
from agentainer_tpu_torch.models import configs as tconfigs
from agentainer_tpu_torch.models.convert import params_from_numpy
from agentainer_tpu_torch.models.llama import MeshCache
from agentainer_tpu_torch.ops.quant import QTensor
from agentainer_tpu_torch.parallel.mesh import make_mesh

pytestmark = pytest.mark.skipif(len(jax.devices()) < 2, reason="needs the virtual multi-device mesh")

TCFG = tconfigs.get_config("tiny")
SHAPE = dict(max_batch=4, max_seq=128, prefill_chunk=64)
# the port's engine options of each case, beside the JAX create options
CASES = {
    "dense": ({}, {}),
    "int8": ({"quant": "int8"}, {}),
    "paged": (None, {"paged_kv": True, "page_size": 16}),
    "fused": (None, {"fused_decode": True}),
}
# a persona-like shared prefix (prefix cache) and a repetitive request
# (prompt-lookup speculation)
PERSONA = "You are a careful on-call assistant for the agent fleet. Answer briefly. "
PROMPTS = (
    (PERSONA + "what failed?", 8),
    ('{"tool": "search", "q": 1}\n' * 4, 24),
    ("the quick brown fox", 12),
    (PERSONA + "and now?", 6),
)


def run(coro):
    return asyncio.run(coro)


def _cpu_mesh(tp):
    return make_mesh(tp, tp=tp, devices=["cpu"] * tp)


@pytest.fixture(scope="module")
def jax_engines():
    made = {}

    def get(name):
        if name not in made:
            made[name] = JEngine.create("tiny", options={**SHAPE, "tp": 2, **CASES[name][0]})
        return made[name]

    yield get
    for e in made.values():
        e.shutdown()


def _port(jeng, tp, **opts):
    """A port engine over the JAX engine's weights (int8 leaves kept)."""
    params = params_from_numpy(jax.tree.map(np.asarray, jeng.params))
    eng = TEngine(TCFG, params, TTok(TCFG.vocab_size), **SHAPE, **opts, device="cpu",
                  mesh=_cpu_mesh(tp) if tp > 1 else None)
    eng.warmup()
    return eng


async def _workload(eng):
    batch = await asyncio.gather(*(eng.generate(p, max_tokens=n, ignore_eos=True) for p, n in PROMPTS))
    a = await eng.chat("s", PERSONA + "first turn", max_tokens=6, ignore_eos=True)
    b = await eng.chat("s", "second turn", max_tokens=7, ignore_eos=True)
    return [r["tokens"] for r in batch] + [a["tokens"], b["tokens"]]


@pytest.mark.parametrize("name", list(CASES))
def test_tp2_greedy_tokens_match_the_reference_and_tp1(jax_engines, name):
    jopts, opts = CASES[name]
    jeng = jax_engines("int8" if name == "int8" else "dense")
    t2, t1 = _port(jeng, 2, **opts), _port(jeng, 1, **opts)
    try:
        assert t2.tp == 2 and t2.metrics()["tp"] == 2
        got = run(_workload(t2))
        assert got == run(_workload(t1))
        if jopts is not None:
            assert got == run(_workload(jeng))
        m = t2.metrics()
        assert m["prefix_hits"] > 0
        assert m["spec_rounds"] > 0 or m["fused_loops_total"] > 0
        if name == "fused":
            assert t2.inloop_spec is False  # off on a mesh, as in the reference
        if name == "int8":
            assert isinstance(t2.params[0]["layers"]["wq"], QTensor)
        assert t2.worker_errors == 0, t2.last_worker_error
    finally:
        t2.shutdown()
        t1.shutdown()


def test_tp_engine_shards_params_and_cache(jax_engines):
    jeng = jax_engines("dense")
    eng = _port(jeng, 2)
    try:
        assert isinstance(eng.params, list) and len(eng.params) == 2
        full = TCFG.n_heads * TCFG.head_dim
        assert [p["layers"]["wq"].shape[-1] for p in eng.params] == [full // 2] * 2
        assert isinstance(eng.cache, MeshCache)
        assert [c.k_store.shape[3] for c in eng.cache.shards] == [TCFG.n_kv_heads // 2] * 2
        m, want = eng.metrics(), jeng.metrics()
        assert (m["tp"], m["ep"]) == (want["tp"], want["ep"]) == (2, 1)
        assert m["param_hbm_bytes"] == want["param_hbm_bytes"]
        assert m["kv_arena_bytes"] == want["kv_arena_bytes"]
    finally:
        eng.shutdown()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_tp2_snapshot_restores_into_tp2_and_tp1(jax_engines, paged):
    """Turn one on a tp=2 engine, its snapshot restored into another tp=2
    engine and into a tp=1 one, turn two there: the JAX tp=2 engine's two
    uninterrupted turns. A tp=1 snapshot restores into tp=2 the same way."""
    jeng = jax_engines("dense")
    opts = {"paged_kv": True, "page_size": 16} if paged else {}
    src2, dst2, src1, dst1 = (_port(jeng, tp, **opts) for tp in (2, 2, 1, 1))
    for e in (src2, src1):
        e.snapshot_min_gap_s = 0

    async def uninterrupted():
        ref = f"ref-{paged}"  # the JAX engine is shared by the module's tests
        a = await jeng.chat(ref, "turn one of a session", max_tokens=6, ignore_eos=True)
        b = await jeng.chat(ref, "turn two", max_tokens=8, ignore_eos=True)
        return a["tokens"], b["tokens"]

    async def resumed(src, dst, session):
        a = await src.chat(session, "turn one of a session", max_tokens=6, ignore_eos=True)
        blob = await src.snapshot_session(session)
        assert await dst.restore_session(session, blob) is True
        b = await dst.chat(session, "turn two", max_tokens=8, ignore_eos=True)
        return a["tokens"], b["tokens"]

    try:
        want = run(uninterrupted())
        assert run(resumed(src2, dst2, "a")) == want
        assert run(resumed(src2, dst1, "b")) == want
        assert run(resumed(src1, dst2, "c")) == want
    finally:
        for e in (src2, dst2, src1, dst1):
            e.shutdown()


def test_tp2_tier_park_and_promote_continue_the_session(jax_engines):
    """A tp=2 paged engine with the host tier: a parked session (each tp
    slice staged, kept unsharded) promotes back and continues as the
    unparked one does."""
    jeng = jax_engines("dense")
    opts = {"paged_kv": True, "page_size": 16, "kv_tiering": True, "tier_quantize": 0}
    eng = _port(jeng, 2, **opts)

    async def turns(park):
        session = f"t{int(park)}"
        a = await eng.chat(session, "turn one of a session", max_tokens=6, ignore_eos=True)
        if park:
            assert await eng.park_session(session)
            assert eng.metrics()["tier_host_sessions"] == 1
        b = await eng.chat(session, "turn two", max_tokens=8, ignore_eos=True)
        return a["tokens"], b["tokens"]

    try:
        assert run(turns(True)) == run(turns(False))
        assert eng.metrics()["tier_promotions_total"] == 1
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# placement


def test_dense_chips_default_to_tp_spanning_the_assignment():
    eng = TEngine.create("tiny", options={"device": "cpu", "chips": [0, 1], "max_batch": 2, "max_seq": 64})
    try:
        assert eng.tp == 2 and eng.mesh.size == 2
        assert run(eng.generate("spanned", max_tokens=4))["completion_tokens"] == 4
    finally:
        eng.shutdown()


@pytest.mark.parametrize("options,want", [
    ({"tp": 4, "chips": [2, 3]}, (2, 1)),  # narrowed to the assignment, never spilled
    ({"tp": 2}, (2, 1)),
    ({"tp": 3}, (1, 1)),  # tiny's 2 kv heads: the largest divisor
    ({"chips": [4]}, (1, 1)),
    ({}, (1, 1)),
])
def test_tp_placement_equals_the_reference(options, want):
    """``_placement`` against the tp the JAX package's ``create`` places
    (values asserted by tests/test_quant.py, tests/test_llm_tp.py)."""
    tp, ep, sp, pp, devices = tllm._placement(TCFG, {"device": "cpu", **options}, options.get("chips", []))
    assert (tp, ep) == want and (sp, pp) == (1, 1) and devices == [torch.device("cpu")] * (tp * ep)


def test_card_placement_clamps_to_visible_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cfg = tconfigs.get_config("llama3-8b")
    place = tllm._placement
    assert place(cfg, {}, [1, 2]) == (2, 1, 1, 1, [torch.device("cuda", 1), torch.device("cuda", 2)])
    # an id past the visible devices: the first ones (the reference's fallback)
    assert place(cfg, {}, [5, 6]) == (2, 1, 1, 1, [torch.device("cuda", 0), torch.device("cuda", 1)])
    assert place(cfg, {"tp": 8}, []) == (4, 1, 1, 1, [torch.device("cuda", i) for i in range(4)])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert place(cfg, {"tp": 2}, [0, 1]) == (1, 1, 1, 1, [torch.device("cuda", 0)])


@pytest.mark.parametrize("axis", ["sp", "pp"])
def test_sp_and_pp_still_raise(axis):
    """sp and pp serve (tests/test_torch_sp.py, test_torch_pp.py); what
    still raises beside tp is the reference's own refusal: a pipeline
    composed with another axis."""
    options = {"device": "cpu", axis: 2, "tp": 2, "pp": 2}
    with pytest.raises(ValueError, match="^serve-time pp does not compose with tp/ep/sp yet$"):
        TEngine.create("tiny", options=options)
    with pytest.raises(ValueError, match="compose"):
        JEngine.create("tiny", options={k: v for k, v in options.items() if k != "device"})


def test_serve_layer_hands_the_chips_over_in_the_hosts_numbering():
    """Under the runtime an engine host sees its chips as
    ``CUDA_VISIBLE_DEVICES``: ``options["chips"]`` is each chip's place in
    that list, so a two-chip agent spans its two visible cards; without
    the variable (or with one that does not list them) the ids pass as
    they are, as in the reference."""
    from agentainer_tpu_torch.engine.llm_serve import LLMServeApp

    env = {"AGENTAINER_MODEL_CONFIG": "tiny", "AGENTAINER_CHIPS": "3,5"}
    assert LLMServeApp(env={**env, "CUDA_VISIBLE_DEVICES": "3,5"})._engine_options()["chips"] == [0, 1]
    assert LLMServeApp(env={**env, "CUDA_VISIBLE_DEVICES": "5,3"})._engine_options()["chips"] == [1, 0]
    assert LLMServeApp(env=env)._engine_options()["chips"] == [3, 5]
    assert LLMServeApp(env={**env, "CUDA_VISIBLE_DEVICES": "3"})._engine_options()["chips"] == [3, 5]
    assert LLMServeApp(env={**env, "CUDA_VISIBLE_DEVICES": "GPU-1a2b"})._engine_options()["chips"] == [3, 5]
