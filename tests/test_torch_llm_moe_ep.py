"""Expert parallelism in the port's engine, on the CPU, against the JAX
package's meshed MoE engine (``tests/test_llm_moe_ep.py``,
``tests/test_moe_routed.py``'s ep case).

``tiny-moe`` (4 experts) at ep=2 and tp=2×ep=2: the JAX engines on the
virtual 8-device CPU mesh, the port's shards on ``cpu``, the port built
from the JAX engine's weights in f32, features on (prefix cache,
speculation, deadlines). Routed MoE is the default under ep > 1 in both.
Held:

- greedy tokens equal the JAX meshed engine's on the dense arena (the
  combination the JAX package's own tests run on XLA:CPU: ep and tp×ep
  engines) and the port's unsharded routed engine's for dense, paged, int8
  weights and the fused loop (the JAX package's tests run no paged, int8
  or fused engine over ep, so those are held to the port's one-device
  engine, which its other tests hold to the JAX engine);
- the expert stacks are cut on the expert axis (and the widths on tp),
  and ``/metrics`` reports ep, tp and routed MoE as the reference does;
- ``routed: false`` on a mesh runs the dense fallback and decodes the same;
- a tp=2×ep=2 snapshot restores into a one-device engine;
- EP-first placement and explicit tp/ep, as the reference places them.
"""

import asyncio

import jax
import numpy as np
import pytest

from agentainer_tpu.engine.llm import LLMEngine as JEngine
from agentainer_tpu_torch.engine import llm as tllm
from agentainer_tpu_torch.engine.llm import LLMEngine as TEngine
from agentainer_tpu_torch.engine.tokenizer import ByteTokenizer as TTok
from agentainer_tpu_torch.models import configs as tconfigs
from agentainer_tpu_torch.models.convert import params_from_numpy
from agentainer_tpu_torch.ops.quant import QTensor
from agentainer_tpu_torch.parallel.mesh import make_mesh

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the virtual 8-device mesh")

TCFG = tconfigs.get_config("tiny-moe")
SHAPE = dict(max_batch=2, max_seq=128, prefill_chunk=64)
MESHES = {"ep2": (1, 2), "tp2_ep2": (2, 2)}
CASES = {
    "dense": {},
    "paged": {"paged_kv": True, "page_size": 16},
    "int8": {"quant": "int8"},
    "fused": {"fused_decode": True},
}
PERSONA = "You are a careful on-call assistant for the agent fleet. "
PROMPTS = ((PERSONA + "what failed?", 6), ('{"tool": "search", "q": 1}\n' * 3, 16), ("a", 5))


def run(coro):
    return asyncio.run(coro)


@pytest.fixture(scope="module")
def jax_engines():
    made = {}

    def get(mesh_name):
        if mesh_name not in made:
            tp, ep = MESHES[mesh_name]
            made[mesh_name] = JEngine.create("tiny-moe", options={**SHAPE, "tp": tp, "ep": ep})
        return made[mesh_name]

    yield get
    for e in made.values():
        e.shutdown()


def _port(jeng, tp, ep, quant=False, **opts):
    from agentainer_tpu_torch.engine.quant import quantize_params

    params = params_from_numpy(jax.tree.map(np.asarray, jeng.params))
    if quant:
        params = quantize_params(params, params["final_norm"].dtype)
    mesh = make_mesh(tp * ep, tp=tp, ep=ep, devices=["cpu"] * (tp * ep)) if tp * ep > 1 else None
    eng = TEngine(TCFG, params, TTok(TCFG.vocab_size), **SHAPE, **opts, device="cpu", mesh=mesh,
                  routed_moe=None if mesh is not None else True)
    eng.warmup()
    return eng


async def _workload(eng):
    batch = await asyncio.gather(*(eng.generate(p, max_tokens=n, ignore_eos=True) for p, n in PROMPTS))
    a = await eng.chat("s", PERSONA + "first turn", max_tokens=5, ignore_eos=True)
    b = await eng.chat("s", "second turn", max_tokens=6, ignore_eos=True)
    return [r["tokens"] for r in batch] + [a["tokens"], b["tokens"]]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_meshed_moe_greedy_tokens_match(jax_engines, mesh_name, case):
    tp, ep = MESHES[mesh_name]
    jeng = jax_engines(mesh_name)
    opts = dict(CASES[case])
    quant = bool(opts.pop("quant", False))
    meshed, single = _port(jeng, tp, ep, quant, **opts), _port(jeng, 1, 1, quant, **opts)
    try:
        assert (meshed.tp, meshed.ep, meshed.routed_moe) == (tp, ep, True)
        got = run(_workload(meshed))
        assert got == run(_workload(single))
        if case == "dense":
            assert jeng.routed_moe is True
            assert got == run(_workload(jeng))
        if quant:
            assert isinstance(meshed.params[0]["layers"]["w_gate"], QTensor)
        assert meshed.metrics()["prefix_hits"] > 0
        assert meshed.worker_errors == 0, meshed.last_worker_error
    finally:
        meshed.shutdown()
        single.shutdown()


def test_ep_engine_cuts_the_experts_and_reports_the_reference_metrics(jax_engines):
    jeng = jax_engines("tp2_ep2")
    eng = _port(jeng, 2, 2)
    try:
        e, d, f = TCFG.n_experts, TCFG.dim, TCFG.ffn_dim
        assert [tuple(p["layers"]["w_gate"].shape[1:]) for p in eng.params] == [(e // 2, d, f // 2)] * 4
        assert [p["layers"]["router"].shape[-1] for p in eng.params] == [e] * 4  # replicated
        got, want = eng.metrics(), jeng.metrics()
        for key in ("tp", "ep", "moe_routed", "moe_decode_dropless", "moe_capacity_factor",
                    "param_hbm_bytes", "kv_arena_bytes"):
            assert got[key] == want[key], key
    finally:
        eng.shutdown()


def test_dense_fallback_on_a_mesh_decodes_the_same(jax_engines):
    """``routed: false`` over ep: every shard computes its experts for
    every token (``parallel/expert.moe_expert_parallel``)."""
    jeng = jax_engines("ep2")
    params = params_from_numpy(jax.tree.map(np.asarray, jeng.params))
    mesh = make_mesh(2, ep=2, devices=["cpu", "cpu"])
    dense = TEngine(TCFG, params, TTok(TCFG.vocab_size), **SHAPE, device="cpu", mesh=mesh, routed_moe=False)
    single = TEngine(TCFG, params, TTok(TCFG.vocab_size), **SHAPE, device="cpu")
    try:
        assert dense.routed_moe is False and dense.metrics()["moe_routed"] is False
        assert run(_workload(dense)) == run(_workload(single))
    finally:
        dense.shutdown()
        single.shutdown()


def test_tp_ep_snapshot_restores_into_one_device(jax_engines):
    jeng = jax_engines("tp2_ep2")
    src, dst = _port(jeng, 2, 2), _port(jeng, 1, 1)
    src.snapshot_min_gap_s = 0

    async def go():
        a = await src.chat("m", "turn one of a session", max_tokens=6, ignore_eos=True)
        blob = await src.snapshot_session("m")
        assert await dst.restore_session("m", blob) is True
        b = await dst.chat("m", "turn two", max_tokens=8, ignore_eos=True)
        return a["tokens"], b["tokens"]

    async def ref():
        a = await jeng.chat("m-ref", "turn one of a session", max_tokens=6, ignore_eos=True)
        b = await jeng.chat("m-ref", "turn two", max_tokens=8, ignore_eos=True)
        return a["tokens"], b["tokens"]

    try:
        assert run(go()) == run(ref())
    finally:
        src.shutdown()
        dst.shutdown()


@pytest.mark.parametrize("options,want", [
    ({"chips": list(range(8))}, (2, 4)),  # EP-first: ep=4, then tp=2 (tests/test_llm_moe_ep.py)
    ({"ep": 4}, (1, 4)),
    ({"tp": 2, "ep": 2}, (2, 2)),
    ({"tp": 2, "chips": [0, 1, 2, 3]}, (2, 2)),  # explicit tp, ep from the rest
    ({"ep": 8, "chips": [0, 1]}, (1, 2)),  # narrowed to the assignment
    ({"chips": [0, 1, 2]}, (1, 2)),  # 3 chips: ep 2 divides the experts, one idle
])
def test_ep_first_placement(options, want):
    tp, ep, sp, pp, devices = tllm._placement(TCFG, {"device": "cpu", **options}, options.get("chips", []))
    assert (tp, ep) == want and (sp, pp) == (1, 1) and len(devices) == tp * ep


def test_create_places_an_moe_agent_ep_first():
    eng = TEngine.create("tiny-moe", options={"device": "cpu", "chips": list(range(8)), **SHAPE})
    try:
        assert (eng.tp, eng.ep, eng.routed_moe) == (2, 4, True)
        assert run(eng.generate("placed", max_tokens=4))["completion_tokens"] == 4
    finally:
        eng.shutdown()
