"""The port's Mixture-of-Experts layer and its engine options against the
JAX package's, on the CPU.

``tiny-moe`` weights come from the JAX ``init_params`` (f32), carried over
by ``params_from_numpy``; each test feeds the reference function and its
port the same numpy inputs, made from a seed. Held:

- ``tests/test_moe_routed.py``'s cases against the port: routed equals
  dense when dropless; the decode shape is dropless at any batch while the
  prefill shape drops at ``cf`` 0.05; overflow drops run and equal the
  reference's output; the capacity model; the FLOP model charges k
  experts, not E; the single-chip engine with ``routed`` decodes the dense
  engine's greedy tokens;
- ``_moe_mlp`` and ``_moe_mlp_routed`` against the reference's, f32 within
  rtol = atol = 2e-5 (the repo's f32 tolerance: the two frameworks sum the
  expert and combine products in their own order), dropless and with
  drops, dense and int8 weights;
- ``forward`` logits against the reference's in f32 at 2e-5 (as
  ``tests/test_models.py`` holds the reference's two attention paths), no
  cache, dense arena and paged arena, dense-einsum and routed MoE;
- ``lax.top_k``'s order on tied logits (the lower index first) and a
  router whose logits all tie choosing the reference's experts;
  ``jax.nn.one_hot``'s all-zero rows for indices out of range, and a slot
  past the capacity dispatching nothing;
- the engine's greedy tokens equal the JAX ``LLMEngine``'s on
  ``tiny-moe`` in f32: dense-einsum and routed (with drops at ``moe_cf``
  1.0 on 128-token prefill chunks), dense arena and paged, f32 weights and
  int8 ones (the quantized tree bit-equal to ``quantize_params``'), with
  the fused loop, and with a snapshot restored across arenas;
- ``param_hbm_bytes`` and the ``/metrics`` MoE keys equal the reference's;
- a Mixtral-layout HF directory loaded in int8 is the reference's
  quantized tree, bit for bit.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentainer_tpu.engine import quant as jeq
from agentainer_tpu.engine.llm import LLMEngine as JEngine
from agentainer_tpu.models import configs as jconfigs
from agentainer_tpu.models import llama as jl
from agentainer_tpu.ops import quant as jq
from agentainer_tpu_torch.engine import quant as teq
from agentainer_tpu_torch.engine.llm import LLMEngine as TEngine
from agentainer_tpu_torch.engine.tokenizer import ByteTokenizer as TTok
from agentainer_tpu_torch.models import configs as tconfigs
from agentainer_tpu_torch.models import llama as tl
from agentainer_tpu_torch.models.convert import params_from_numpy
from agentainer_tpu_torch.ops import cuda_quant
from agentainer_tpu_torch.ops import quant as tq

TOL = 2e-5
JCFG, TCFG = jconfigs.get_config("tiny-moe"), tconfigs.get_config("tiny-moe")
MOE_KEYS = ("router", "w_gate", "w_up", "w_down")


def run(coro):
    return asyncio.run(coro)


@pytest.fixture(scope="module")
def jparams():
    """The JAX init tree of tiny-moe in f32, as numpy."""
    return jax.tree.map(np.asarray, jl.init_params(JCFG, jax.random.PRNGKey(3), dtype=jnp.float32))


def _layer0(tree, quant: bool):
    """Layer 0's MoE leaves of a tree (quantized first with ``quant``): the
    reference's dequantized, as its forward hands them to the layer, and
    the port's as it slices them."""
    if quant:
        tree = jeq.quantize_params(tree, dtype=jnp.float32)
    jlp = {k: jq.dequant(jax.tree.map(lambda a: jnp.asarray(a)[0], tree["layers"][k])) for k in MOE_KEYS}
    tp = params_from_numpy(jax.tree.map(np.asarray, tree))
    tlp = {k: tq.layer_slice(tp["layers"][k], 0) for k in MOE_KEYS}
    return jlp, tlp


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(fn_j, fn_t, x, jlp, tlp, **kw):
    want = np.asarray(fn_j(jnp.asarray(x), jlp, JCFG, **kw))
    with torch.no_grad():
        got = fn_t(torch.from_numpy(x), tlp, TCFG, **kw).numpy()
    return got, want


# -- the layer ------------------------------------------------------------------

DROPLESS_CF = TCFG.n_experts / TCFG.experts_per_token


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize(
    "impl,shape,cf",
    [
        ("dense", (2, 16), None),
        ("routed", (2, 16), DROPLESS_CF),  # n = 32 <= 64: dropless by size
        ("routed", (1, 96), 1.0),  # prefill-shaped, cap 48: drops
        ("routed", (1, 96), 0.05),  # cap 2: heavy drops
        ("routed", (128, 1), 0.05),  # decode-shaped: dropless at any cf
    ],
    ids=["dense", "routed-dropless", "routed-cf1", "routed-cf0.05", "routed-decode"],
)
def test_moe_layer_matches_the_reference(jparams, impl, shape, cf, quant):
    jlp, tlp = _layer0(jparams, quant)
    x = _x((*shape, TCFG.dim), seed=sum(shape))
    if impl == "dense":
        got, want = _both(jl._moe_mlp, tl._moe_mlp, x, jlp, tlp)
    else:
        got, want = _both(jl._moe_mlp_routed, tl._moe_mlp_routed, x, jlp, tlp, capacity_factor=cf)
    assert got.shape == want.shape == x.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_routed_matches_dense_when_dropless(jparams):
    _, tlp = _layer0(jparams, False)
    x = torch.from_numpy(_x((2, 16, TCFG.dim), seed=5))
    dense = tl._moe_mlp(x, tlp, TCFG)
    routed = tl._moe_mlp_routed(x, tlp, TCFG, capacity_factor=DROPLESS_CF)
    np.testing.assert_allclose(routed.numpy(), dense.numpy(), atol=1e-5)


def test_decode_shape_dropless_any_batch(jparams):
    """Dropless decode is gated on the call shape (t == 1): 128 lanes at a
    starvation-level factor equal the dense MoE, while the prefill shape of
    the same token count honours the cap and drops."""
    _, tlp = _layer0(jparams, False)
    x = torch.from_numpy(_x((128, 1, TCFG.dim), seed=7))
    dense = tl._moe_mlp(x, tlp, TCFG)
    routed = tl._moe_mlp_routed(x, tlp, TCFG, capacity_factor=0.05)
    np.testing.assert_allclose(routed.numpy(), dense.numpy(), atol=1e-5)
    routed_p = tl._moe_mlp_routed(x.reshape(1, 128, -1), tlp, TCFG, capacity_factor=0.05)
    assert not np.allclose(routed_p.numpy(), dense.reshape(1, 128, -1).numpy())


def test_routed_drops_overflow_tokens_without_crashing(jparams):
    jlp, tlp = _layer0(jparams, False)
    x = _x((1, 96, TCFG.dim), seed=5)
    got, want = _both(jl._moe_mlp_routed, tl._moe_mlp_routed, x, jlp, tlp, capacity_factor=0.05)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize(
    "n,e,k,cf", [(1024, 8, 2, 2.0), (1024, 8, 2, 1.0), (8, 8, 2, 16.0), (1, 8, 2, 1.0), (96, 4, 2, 0.05)]
)
def test_routed_capacity_model(n, e, k, cf):
    assert tl.routed_capacity(n, e, k, cf) == jl.routed_capacity(n, e, k, cf)
    assert {(1024, 2.0): 512, (1024, 1.0): 256, (8, 16.0): 8, (1, 1.0): 1, (96, 0.05): 3}[n, cf] == (
        tl.routed_capacity(n, e, k, cf)
    )
    assert tl._DROPLESS_MAX_N == jl._DROPLESS_MAX_N == 64


def test_flop_model_charges_k_not_e():
    """Doubling the expert count (k fixed) leaves the per-token MLP FLOPs
    alone; the model equals the reference's."""
    doubled = dataclasses.replace(TCFG, name="tiny-moe-2x", n_experts=TCFG.n_experts * 2)

    def mlp_flops(cfg):
        return cfg.flops_per_token(0) - 2.0 * cfg.n_layers * cfg.dim * cfg.n_experts

    assert mlp_flops(TCFG) == mlp_flops(doubled)
    for ctx in (0, 17, 200):
        assert TCFG.flops_per_token(ctx) == JCFG.flops_per_token(ctx)


def test_top_k_keeps_the_lower_index_first_on_ties():
    """Integer logits over 8 experts tie often: the values and the order of
    the indices are ``lax.top_k``'s."""
    logits = np.random.default_rng(0).integers(-2, 3, (64, 8)).astype(np.float32)
    for k in (1, 2, 3, 8):
        wv, wi = jax.lax.top_k(jnp.asarray(logits), k)
        gv, gi = tl._top_k(torch.from_numpy(logits), k)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


@pytest.mark.parametrize("impl", ["dense", "routed"])
def test_a_tied_router_chooses_the_reference_experts(jparams, impl):
    """A zero router ties every logit: both packages send every token to
    experts 0 and 1 with weight 1/2 each."""
    jlp, tlp = _layer0(jparams, False)
    jlp = {**jlp, "router": jnp.zeros_like(jlp["router"])}
    tlp = {**tlp, "router": torch.zeros_like(tlp["router"])}
    x = _x((2, 8, TCFG.dim), seed=9)
    fns = (jl._moe_mlp, tl._moe_mlp) if impl == "dense" else (jl._moe_mlp_routed, tl._moe_mlp_routed)
    got, want = _both(*fns, x, jlp, tlp)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    only01 = {**tlp, "w_down": tlp["w_down"].clone()}
    only01["w_down"][2:] = 0.0  # experts 2 and 3 contribute nothing if unchosen
    with torch.no_grad():
        np.testing.assert_allclose(tl._moe_mlp(torch.from_numpy(x), only01, TCFG).numpy(), got, rtol=TOL, atol=TOL)


def test_out_of_range_one_hot_rows_are_zero():
    idx = np.array([[-3, -1, 0, 2], [3, 4, 7, 1]], np.int32)
    want = np.asarray(jax.nn.one_hot(jnp.asarray(idx), 4, dtype=jnp.float32))
    got = tl._one_hot(torch.from_numpy(idx), 4, torch.float32).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[0, :2].any() and not got[1, 1:3].any() and got[1, 0, 3] == 1


def test_a_slot_past_the_capacity_dispatches_nothing(jparams):
    """At cap 1 every expert keeps its first token only: the output of a
    token that no expert kept is zero, in both packages; each kept token's
    output is its one expert's weighted contribution."""
    jlp, tlp = _layer0(jparams, False)
    x = _x((1, 96, TCFG.dim), seed=13)
    cap = tl.routed_capacity(96, TCFG.n_experts, TCFG.experts_per_token, 0.01)
    assert cap == 1
    got, want = _both(jl._moe_mlp_routed, tl._moe_mlp_routed, x, jlp, tlp, capacity_factor=0.01)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    kept = np.abs(got[0]).sum(-1) > 0
    assert 1 <= kept.sum() <= TCFG.n_experts  # one token per expert at most


# -- the forward ----------------------------------------------------------------


@pytest.fixture(scope="module")
def trees(jparams):
    """Each package's tree of the same weights, in f32 and quantized."""
    jq8 = jeq.quantize_params(jparams, dtype=jnp.float32)
    return {
        "f32": (jparams, params_from_numpy(jparams)),
        "int8": (jq8, params_from_numpy(jax.tree.map(np.asarray, jq8))),
    }


def _impls(routed: bool, cf: float = 1.0):
    if not routed:
        return None, None
    return (
        lambda h, lp: jl._moe_mlp_routed(h, lp, JCFG, capacity_factor=cf),
        lambda h, lp: tl._moe_mlp_routed(h, lp, TCFG, capacity_factor=cf),
    )


@pytest.mark.parametrize("weights", ["f32", "int8"])
@pytest.mark.parametrize("routed", [False, True], ids=["dense_moe", "routed"])
@pytest.mark.parametrize("arena", ["none", "dense", "paged"])
def test_forward_logits_match_the_reference(trees, weights, routed, arena):
    """Prefill of 2 × 40 tokens (routed: 80 tokens over 4 experts at cf 1.0,
    cap 40, with drops), then one decode step; logits within 2e-5."""
    jp, tp = trees[weights]
    jimpl, timpl = _impls(routed)
    b, t = 2, 40
    rng = np.random.default_rng(21)
    toks = rng.integers(0, TCFG.vocab_size, (b, t)).astype(np.int32)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t)) + np.array([[0], [7]], np.int32)
    jcache = tcache = jtable = ttable = None
    if arena == "dense":
        jcache = jl.KVCache.create(JCFG, b, 64, dtype=jnp.float32)
        tcache = tl.KVCache.create(TCFG, b, 64, dtype=torch.float32)
    elif arena == "paged":
        table = rng.permutation(10)[:8].astype(np.int32).reshape(b, 4)
        jcache = jl.PagedKVCache.create(JCFG, 10, 16, dtype=jnp.float32)
        tcache = tl.PagedKVCache.create(TCFG, 10, 16, dtype=torch.float32)
        jtable, ttable = jnp.asarray(table), torch.from_numpy(table)
    steps = [(toks, pos)] + ([(toks[:, -1:], pos[:, -1:] + 1)] if arena != "none" else [])
    for tk, ps in steps:
        want, jcache = jl.forward(jp, JCFG, jnp.asarray(tk), jnp.asarray(ps), jcache,
                                  moe_impl=jimpl, block_table=jtable)
        with torch.no_grad():
            got = tl.forward(tp, TCFG, torch.from_numpy(tk).long(), torch.from_numpy(ps), tcache,
                             block_table=ttable, moe_impl=timpl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def _shapes(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        out.update(_shapes(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: tuple(v.shape)})
    return out


def test_init_params_has_the_reference_tree():
    want = jax.eval_shape(lambda: jl.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32))
    got = tl.init_params(TCFG, torch.Generator().manual_seed(0), dtype=torch.float32)
    assert _shapes(got) == _shapes(want)
    assert float(got["layers"]["w_up"].std()) == pytest.approx(0.02, rel=0.05)


def test_params_from_numpy_carries_the_expert_stacks(trees, jparams):
    _, tp = trees["f32"]
    assert tuple(tp["layers"]["w_down"].shape) == (2, 4, 128, 64)
    np.testing.assert_array_equal(tp["layers"]["w_gate"].numpy(), jparams["layers"]["w_gate"])
    jq8, tq8 = trees["int8"]
    for k in MOE_KEYS:
        assert isinstance(tq8["layers"][k], tq.QTensor)
        np.testing.assert_array_equal(tq8["layers"][k].q.numpy(), np.asarray(jq8["layers"][k].q))
        np.testing.assert_array_equal(tq8["layers"][k].scale.numpy(), np.asarray(jq8["layers"][k].scale))
    # and the port's own quantizer gives the reference's tree, bit for bit
    mine = teq.quantize_params(params_from_numpy(jparams), torch.float32)
    for k in MOE_KEYS:
        assert torch.equal(mine["layers"][k].q, tq8["layers"][k].q)
        assert torch.equal(mine["layers"][k].scale, tq8["layers"][k].scale)


@pytest.mark.parametrize("dtype", ["F32", "BF16"])
def test_quantized_mixtral_checkpoint_load_is_the_reference_tree(tmp_path, dtype):
    """A Mixtral-layout HF directory loaded with ``quant="int8"`` (each
    expert quantized as it streams) equals the reference's
    ``quantize_params`` of its own load, leaf for leaf, bit for bit."""
    from agentainer_tpu.engine import hf_convert as jhf
    from agentainer_tpu_torch.engine import hf_convert as thf
    from tests.test_torch_hf_convert import write_hf

    write_hf(tmp_path, TCFG, dtype=dtype, shards=2)
    want = jeq.quantize_params(
        jax.tree.map(np.asarray, jhf.load_hf_params(JCFG, tmp_path, dtype=jnp.float32)), dtype=jnp.float32
    )
    got = thf.load_hf_params(TCFG, tmp_path, dtype=torch.float32, device="cpu", quant="int8")
    for k in MOE_KEYS:
        assert isinstance(got["layers"][k], tq.QTensor), k
        np.testing.assert_array_equal(got["layers"][k].q.numpy(), np.asarray(want["layers"][k].q), err_msg=k)
        np.testing.assert_array_equal(got["layers"][k].scale.numpy(), np.asarray(want["layers"][k].scale), err_msg=k)


def test_grouped_products_run_the_kernels_plain_version(trees):
    """On the CPU an int8 expert stack goes through ``w8a16_grouped_matmul``'s
    plain version, shared and per-expert x; a dense stack is a batched
    product."""
    _, tp = trees["int8"]
    w = tq.layer_slice(tp["layers"]["w_gate"], 1)
    x = torch.from_numpy(_x((5, TCFG.dim), seed=1))
    got = tq.qmatmul_experts(x, w)
    assert tuple(got.shape) == (TCFG.n_experts, 5, TCFG.ffn_dim)
    torch.testing.assert_close(got, cuda_quant.w8a16_matmul_plain(x, w.q, w.scale), rtol=0, atol=0)
    x3 = torch.from_numpy(_x((TCFG.n_experts, 5, TCFG.dim), seed=2))
    for e in range(TCFG.n_experts):
        torch.testing.assert_close(
            tq.qmatmul_experts(x3, w)[e], cuda_quant.w8a16_matmul_plain(x3[e], w.q[e], w.scale[e]),
            rtol=0, atol=0,
        )
    dense = tq.dequant(w)
    torch.testing.assert_close(tq.qmatmul_experts(x, dense), x @ dense, rtol=0, atol=0)


# -- the engine -------------------------------------------------------------------

SHAPE = dict(max_batch=4, max_seq=256, decode_chunk=8)
FEATURES_OFF = dict(prefix_cache=False, speculative=False, deadlines=False)
# name: (JAX options, the port's extra constructor options)
ENGINES = {
    "dense_moe": ({"prefill_chunk": 32}, {"prefill_chunk": 32}),
    "routed_cf1_paged": (
        {"prefill_chunk": 128, "routed": True, "moe_cf": 1.0, "paged_kv": True, "page_size": 16},
        {"prefill_chunk": 128, "routed_moe": True, "moe_capacity_factor": 1.0, "paged_kv": True,
         "page_size": 16},
    ),
    "int8_dense_moe_paged": (
        {"prefill_chunk": 32, "quant": "int8", "paged_kv": True, "page_size": 16},
        {"prefill_chunk": 32, "paged_kv": True, "page_size": 16},
    ),
    "int8_routed": (
        {"prefill_chunk": 128, "quant": "int8", "routed": True, "moe_cf": 1.0},
        {"prefill_chunk": 128, "routed_moe": True, "moe_capacity_factor": 1.0},
    ),
}


def _port(jeng, **opts) -> TEngine:
    tp = params_from_numpy(jax.tree.map(np.asarray, jeng.params))
    eng = TEngine(TCFG, tp, TTok(TCFG.vocab_size), **SHAPE, **FEATURES_OFF, **opts, device="cpu")
    eng.warmup()
    return eng


@pytest.fixture(scope="module")
def jax_engine():
    """The reference's engine of each ``ENGINES`` entry, made once."""
    made: dict[str, JEngine] = {}

    def get(name: str) -> JEngine:
        if name not in made:
            made[name] = JEngine.create("tiny-moe", options={**SHAPE, **FEATURES_OFF, **ENGINES[name][0]})
        return made[name]

    yield get
    for eng in made.values():
        eng.shutdown()


@pytest.fixture(scope="module", params=list(ENGINES))
def engines(request, jax_engine):
    jeng = jax_engine(request.param)
    teng = _port(jeng, **ENGINES[request.param][1])
    yield request.param, jeng, teng
    teng.shutdown()


# a 100-byte prompt: one 128-token chunk (routed engines: cap 64 at cf 1.0)
PROMPTS = (("the quick brown fox", 13), ("mixture of experts, " * 5, 11), ("a", 6), ("routed parity", 9))


def test_engine_greedy_tokens_match_the_reference(engines):
    name, jeng, teng = engines
    assert teng.routed_moe is jeng.routed_moe is ("routed" in name)
    if "int8" in name:
        assert isinstance(teng.params["layers"]["w_up"], tq.QTensor)

    async def batch(eng):
        return await asyncio.gather(*(eng.generate(p, max_tokens=m, ignore_eos=True) for p, m in PROMPTS))

    assert [r["tokens"] for r in run(batch(teng))] == [r["tokens"] for r in run(batch(jeng))]

    async def turns(eng):
        a = await eng.chat("moe-two", "first turn", max_tokens=6, ignore_eos=True)
        b = await eng.chat("moe-two", "the second turn", max_tokens=7, ignore_eos=True)
        return a["tokens"], b["tokens"]

    assert run(turns(teng)) == run(turns(jeng))


def test_engine_footprint_and_moe_metrics_match_the_reference(engines):
    name, jeng, teng = engines
    assert teng.param_hbm_bytes == jeq.param_bytes_actual(jeng.params) == teng.metrics()["param_hbm_bytes"]
    want, got = jeng.metrics(), teng.metrics()
    for key in ("moe_routed", "moe_decode_dropless", "moe_capacity_factor"):
        assert got[key] == want[key], key
    assert got["moe_capacity_factor"] == (1.0 if "routed" in name else None)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_fused_engine_decodes_the_reference_tokens(jax_engine, paged):
    """The fused on-device loop over the MoE forward (in-loop spec off:
    features off) decodes the reference engine's greedy tokens."""
    jeng = jax_engine("dense_moe")
    eng = _port(jeng, prefill_chunk=32, fused_decode=True, paged_kv=paged, page_size=16)
    try:
        for prompt, n in PROMPTS[:2]:
            want = run(jeng.generate(prompt, max_tokens=n, ignore_eos=True))
            assert run(eng.generate(prompt, max_tokens=n, ignore_eos=True))["tokens"] == want["tokens"]
        assert eng.metrics()["fused_loops_total"] > 0
    finally:
        eng.shutdown()


def test_snapshot_restored_across_arenas_continues_the_reference_session(jax_engine):
    """Turn one on a dense port engine, its snapshot restored into a paged
    port engine (routed), turn two there: the JAX engine's uninterrupted
    two turns."""
    jeng = jax_engine("dense_moe")
    dense = _port(jeng, prefill_chunk=32)
    paged = _port(jeng, prefill_chunk=32, paged_kv=True, page_size=16, routed_moe=True,
                  moe_capacity_factor=DROPLESS_CF)
    dense.snapshot_min_gap_s = 0
    try:
        async def resumed():
            a = await dense.chat("snap", "turn one of a session", max_tokens=6, ignore_eos=True)
            blob = await dense.snapshot_session("snap")
            assert await paged.restore_session("snap", blob) is True
            b = await paged.chat("snap", "turn two", max_tokens=8, ignore_eos=True)
            return a["tokens"], b["tokens"]

        async def uninterrupted():
            a = await jeng.chat("snap-ref", "turn one of a session", max_tokens=6, ignore_eos=True)
            b = await jeng.chat("snap-ref", "turn two", max_tokens=8, ignore_eos=True)
            return a["tokens"], b["tokens"]

        assert run(resumed()) == run(uninterrupted())
    finally:
        dense.shutdown()
        paged.shutdown()


def test_single_chip_engine_routed_opt_in_matches_dense():
    """The port's own engines, as tests/test_moe_routed.py holds the
    reference's: routed at a dropless factor decodes the dense engine's
    tokens, and the flag is reported."""
    opts = {"device": "cpu", "max_batch": 2, "max_seq": 128}
    dense = TEngine.create("tiny-moe", options=opts)
    routed = TEngine.create("tiny-moe", options={**opts, "routed": True, "moe_cf": DROPLESS_CF})
    try:
        assert dense.routed_moe is False and routed.routed_moe is True
        assert dense.metrics()["moe_routed"] is False and routed.metrics()["moe_routed"] is True
        a = run(dense.generate("routed moe parity", max_tokens=6))
        b = run(routed.generate("routed moe parity", max_tokens=6))
        assert a["tokens"] == b["tokens"]
    finally:
        dense.shutdown()
        routed.shutdown()


def test_create_serves_synthetic_int8_moe_on_the_cpu():
    """``quant: int8, synthetic: true`` on an MoE config: the reference's
    tree of int8 leaves (router included), served."""
    eng = TEngine.create(
        "tiny-moe", options={"device": "cpu", "max_batch": 2, "max_seq": 64, "quant": "int8",
                             "synthetic": True, "skip_warmup": True},
    )
    try:
        for k in MOE_KEYS:
            assert isinstance(eng.params["layers"][k], tq.QTensor), k
        assert tuple(eng.params["layers"]["w_gate"].q.shape) == (2, 4, 64, 128)
        want = jax.eval_shape(lambda: jeq.synthetic_quantized_params(JCFG, jnp.float32))
        assert eng.param_hbm_bytes == sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(want))
        assert run(eng.generate("int8 moe", max_tokens=4, ignore_eos=True))["completion_tokens"] == 4
    finally:
        eng.shutdown()
