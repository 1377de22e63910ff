"""The port's int8 weight-only serving against the JAX package's on the CPU.

Held, on inputs made with numpy from a seed:

- quantization is the reference's bit for bit: ``quantize_array`` and
  ``quantize_params`` (``q`` and ``scale`` bit-equal, f32 and bf16 scales,
  an all-zero column, stacked ``[L, K, N]`` leaves), the quantized HF load
  against the reference's ``quantize_params(load_params(...))``, and the
  KV-page quantization of the host tier;
- ``dequant``, ``embed_lookup`` and ``qmatmul`` (the kernel's plain version
  here) against ``x @ dequant(w)`` in JAX, f32 within rtol = atol = 2e-5
  (the repo's f32 kernel tolerance: the port scales after the sum, the
  reference before, so the two differ by summation rounding only);
- ``forward`` over a quantized tree carried across by ``params_from_numpy``
  against the reference's ``forward`` over the same tree, dense and paged,
  logits within 2e-5;
- an engine built from the JAX engine's quantized tree decodes the JAX
  engine's greedy tokens: one request, a concurrent batch, a two-turn
  session;
- ``synthetic_quantized_params`` has the reference's tree, shapes and
  dtypes (``tiny`` and, on the meta device, ``llama3-8b``), int8 in
  [-127, 127], a constant scale, and one seed gives one tree;
- ``param_bytes_actual`` and the engine's ``param_hbm_bytes`` equal the
  reference's footprint;
- the kernel's shape rule and split plan cover every weight of llama3-8b
  and bench-1b, and a card engine refuses a quantized model whose weights
  the kernel does not take.
"""

import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from agentainer_tpu.engine import hf_convert as jhf
from agentainer_tpu.engine import quant as jeq
from agentainer_tpu.engine.llm import LLMEngine as JEngine
from agentainer_tpu.models import configs as jconfigs
from agentainer_tpu.models import llama as jl
from agentainer_tpu.ops import quant as jq
from agentainer_tpu_torch.engine import hf_convert as thf
from agentainer_tpu_torch.engine import quant as teq
from agentainer_tpu_torch.engine.llm import LLMEngine as TEngine
from agentainer_tpu_torch.engine.tokenizer import ByteTokenizer as TTok
from agentainer_tpu_torch.models import configs as tconfigs
from agentainer_tpu_torch.models import llama as tl
from agentainer_tpu_torch.models.convert import params_from_numpy
from agentainer_tpu_torch.ops import cuda_quant
from agentainer_tpu_torch.ops import quant as tq
from tests.test_torch_hf_convert import write_hf

TOL = 2e-5
# unregistered, test-only config with a kernel-shaped head (head_dim 128)
HD128 = dict(
    name="test-hd128", vocab_size=300, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
    ffn_dim=512, max_seq_len=256, rope_theta=10_000.0,
)


def _bits(x) -> np.ndarray:
    """A tensor or array as its raw bits (bf16 through 16-bit ints)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == ml_dtypes.bfloat16 else x


def _assert_qtensor_equal(got: tq.QTensor, want: jq.QTensor, name=""):
    assert isinstance(got, tq.QTensor), name
    assert got.q.dtype == torch.int8 and tuple(got.q.shape) == want.q.shape, name
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q), err_msg=f"{name}.q")
    assert tuple(got.scale.shape) == want.scale.shape, name
    np.testing.assert_array_equal(_bits(got.scale), _bits(want.scale), err_msg=f"{name}.scale")


def _weights(shape, seed, zero_col=False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32) * 0.02
    w[..., 7] *= 40.0  # an outlier channel
    if zero_col:
        w[..., 3] = 0.0  # all-zero output channel: scale 1, q 0
    return w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "shape,zero_col",
    [((64, 32), False), ((64, 32), True), ((3, 128, 48), True), ((2, 4, 64, 16), False)],
)
def test_quantize_array_bit_equal(shape, zero_col, dtype):
    w = _weights(shape, seed=sum(shape), zero_col=zero_col)
    want = jq.quantize_array(w, dtype=getattr(jnp, dtype))
    got = tq.quantize_array(w, dtype=getattr(torch, dtype))
    _assert_qtensor_equal(got, want)
    # from a tensor, in place on its device
    _assert_qtensor_equal(tq.quantize_array(torch.from_numpy(w), dtype=getattr(torch, dtype)), want)
    if zero_col:
        assert (got.q[..., 3] == 0).all() and (got.scale[..., 3] == 1).all()


def _tiny_jax_params(dtype=jnp.float32):
    return jl.init_params(jconfigs.get_config("tiny"), jax.random.PRNGKey(0), dtype=dtype)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _assert_tree_equal(got: dict, want: dict):
    g, w = dict(_flat(got)), dict(_flat(want))
    assert sorted(g) == sorted(w)
    for name, wl in w.items():
        if isinstance(wl, jq.QTensor):
            _assert_qtensor_equal(g[name], wl, name)
        else:
            assert not isinstance(g[name], tq.QTensor), name
            np.testing.assert_array_equal(_bits(g[name]), _bits(wl), err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_params_bit_equal(dtype):
    jp = jax.tree.map(np.asarray, _tiny_jax_params())
    want = jeq.quantize_params(jp, dtype=getattr(jnp, dtype))
    got = teq.quantize_params(params_from_numpy(jp), dtype=getattr(torch, dtype))
    _assert_tree_equal(got, want)
    assert got["layers"]["attn_norm"].dtype == getattr(torch, dtype)


def test_dequant_and_embed_lookup_match_jax():
    w = _weights((40, 24), seed=1)
    jt, tt = jq.quantize_array(w, jnp.float32), tq.quantize_array(w, torch.float32)
    np.testing.assert_allclose(tq.dequant(tt).numpy(), np.asarray(jq.dequant(jt)), rtol=TOL, atol=TOL)
    toks = np.random.default_rng(2).integers(0, 40, (3, 5))
    want = jq.embed_lookup(jt, jnp.asarray(toks))
    got = tq.embed_lookup(tt, torch.from_numpy(toks))
    assert tuple(got.shape) == (3, 5, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    dense = torch.from_numpy(w)
    assert tq.dequant(dense) is dense


@pytest.mark.parametrize("lead", [(8,), (2, 7), (1, 1, 3)])
def test_qmatmul_plain_matches_jax(lead):
    rng = np.random.default_rng(len(lead))
    w = _weights((64, 48), seed=3, zero_col=True)
    x = rng.standard_normal((*lead, 64)).astype(np.float32)
    want = jnp.asarray(x) @ jq.dequant(jq.quantize_array(w, jnp.float32))
    qt = tq.quantize_array(w, torch.float32)
    got = tq.qmatmul(torch.from_numpy(x), qt)
    assert tuple(got.shape) == (*lead, 48) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    # the kernel's plain version is what the CPU runs
    np.testing.assert_array_equal(
        got.reshape(-1, 48).numpy(),
        cuda_quant.w8a16_matmul_plain(torch.from_numpy(x).reshape(-1, 64), qt.q, qt.scale).numpy(),
    )
    # a dense weight is a plain product
    np.testing.assert_array_equal(
        tq.qmatmul(torch.from_numpy(x), torch.from_numpy(w)).numpy(), (torch.from_numpy(x) @ torch.from_numpy(w)).numpy()
    )


def _configs(name):
    if name == "tiny":
        return jconfigs.get_config("tiny"), tconfigs.get_config("tiny")
    return jconfigs.ModelConfig(**HD128), tconfigs.ModelConfig(**HD128)


@pytest.fixture(scope="module", params=["tiny", "hd128"])
def qmodel(request):
    jcfg, tcfg = _configs(request.param)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    jqp = jeq.quantize_params(jax.tree.map(np.asarray, jp), dtype=jnp.float32)
    tqp = params_from_numpy(jax.tree.map(np.asarray, jqp))
    return jcfg, tcfg, jqp, tqp


def _inputs(cfg, b, t, offsets, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    pos = (np.asarray(offsets, np.int32)[:, None] + np.arange(t, dtype=np.int32)[None]).astype(np.int32)
    return toks, pos


def test_quantized_forward_matches_jax_dense_arena(qmodel):
    jcfg, tcfg, jqp, tqp = qmodel
    assert isinstance(tqp["layers"]["wq"], tq.QTensor) and isinstance(tqp["embed"], tq.QTensor)
    toks, pos = _inputs(jcfg, 2, 10, [0, 20], seed=1)
    jc = jl.KVCache.create(jcfg, 2, 48, dtype=jnp.float32)
    tc = tl.KVCache.create(tcfg, 2, 48, dtype=torch.float32)
    want, jc = jl.forward(jqp, jcfg, jnp.asarray(toks), jnp.asarray(pos), jc)
    with torch.no_grad():
        got = tl.forward(tqp, tcfg, torch.from_numpy(toks).long(), torch.from_numpy(pos), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    nxt, npos = toks[:, -1:], pos[:, -1:] + 1
    want, _ = jl.forward(jqp, jcfg, jnp.asarray(nxt), jnp.asarray(npos), jc)
    with torch.no_grad():
        got = tl.forward(tqp, tcfg, torch.from_numpy(nxt).long(), torch.from_numpy(npos), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    # no cache: the causal path
    want, _ = jl.forward(jqp, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    with torch.no_grad():
        got = tl.forward(tqp, tcfg, torch.from_numpy(toks).long(), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_quantized_forward_matches_jax_paged_arena(qmodel):
    jcfg, tcfg, jqp, tqp = qmodel
    b, t, ps, nb, n_pages = 2, 10, 16, 3, 8
    rng = np.random.default_rng(15)
    toks, pos = _inputs(jcfg, b, t, [0, 30], seed=4)
    table = rng.permutation(n_pages)[: b * nb].astype(np.int32).reshape(b, nb)
    jc = jl.PagedKVCache.create(jcfg, n_pages, ps, dtype=jnp.float32)
    tc = tl.PagedKVCache.create(tcfg, n_pages, ps, dtype=torch.float32)
    want, jc = jl.forward(jqp, jcfg, jnp.asarray(toks), jnp.asarray(pos), jc, block_table=jnp.asarray(table))
    with torch.no_grad():
        got = tl.forward(
            tqp, tcfg, torch.from_numpy(toks).long(), torch.from_numpy(pos), tc,
            block_table=torch.from_numpy(table),
        )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_layer_slice_takes_each_field():
    """A stacked QTensor sliced per layer gives that layer's q and scale
    (indexing the NamedTuple itself would give its fields)."""
    qt = tq.quantize_array(_weights((3, 16, 8), seed=5), torch.float32)
    for i in range(3):
        got = tq.layer_slice(qt, i)
        assert isinstance(got, tq.QTensor)
        assert torch.equal(got.q, qt.q[i]) and torch.equal(got.scale, qt.scale[i])
    dense = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(tq.layer_slice(dense, 1), dense[1])


# -- the engine ---------------------------------------------------------------

SHAPE = dict(max_batch=4, max_seq=128, prefill_chunk=32, decode_chunk=8)
FEATURES_OFF = dict(prefix_cache=False, speculative=False, deadlines=False)


@pytest.fixture(scope="module")
def qengines():
    jeng = JEngine.create("tiny", options={"quant": "int8", **SHAPE, **FEATURES_OFF})
    tcfg = tconfigs.get_config("tiny")
    tp = params_from_numpy(jax.tree.map(np.asarray, jeng.params))
    teng = TEngine(tcfg, tp, TTok(tcfg.vocab_size), **SHAPE, **FEATURES_OFF, device="cpu")
    teng.warmup()
    yield jeng, teng
    jeng.shutdown()
    teng.shutdown()


def run(coro):
    return asyncio.run(coro)


def test_quantized_engine_single_request_matches(qengines):
    jeng, teng = qengines
    assert isinstance(teng.params["layers"]["w_down"], tq.QTensor)
    for prompt, n in (("quantized hello", 10), ("the quick brown fox", 17)):
        want = run(jeng.generate(prompt, max_tokens=n, ignore_eos=True))
        got = run(teng.generate(prompt, max_tokens=n, ignore_eos=True))
        assert got["tokens"] == want["tokens"]


def test_quantized_engine_concurrent_batch_matches(qengines):
    jeng, teng = qengines
    reqs = [("msg zero", 3), ("a second message", 9), ("third", 6), ("and the fourth one", 12)]

    async def batch(eng):
        return await asyncio.gather(*(eng.generate(p, max_tokens=m, ignore_eos=True) for p, m in reqs))

    assert [r["tokens"] for r in run(batch(teng))] == [r["tokens"] for r in run(batch(jeng))]


def test_quantized_engine_two_turn_session_matches(qengines):
    jeng, teng = qengines

    async def turns(eng):
        a = await eng.chat("q-two", "first turn", max_tokens=6, ignore_eos=True)
        b = await eng.chat("q-two", "second turn", max_tokens=7, ignore_eos=True)
        return a["tokens"], b["tokens"]

    assert run(turns(teng)) == run(turns(jeng))


def test_quantized_engine_reports_the_int8_footprint(qengines):
    jeng, teng = qengines
    want = jeq.param_bytes_actual(jeng.params)
    assert teq.param_bytes_actual(teng.params) == want
    assert teng.param_hbm_bytes == want == teng.metrics()["param_hbm_bytes"]
    assert "w8a16_matmul" in teng.metrics()["kernel_launches"]


@pytest.mark.parametrize(
    "options",
    [{"quant": "int8"}, {"quant": "INT8", "synthetic": True}, {"synthetic": True}],
    ids=["quant", "synthetic-quant", "synthetic-alone"],
)
def test_create_serves_int8_on_cpu(options):
    """``quant`` alone: the seed's random init quantized; with
    ``synthetic``: int8 drawn on the device; ``synthetic`` alone: a plain
    random init, as in the reference."""
    eng = TEngine.create(
        "tiny", options={"device": "cpu", "max_batch": 2, "max_seq": 128, "skip_warmup": True, **options}
    )
    try:
        quantized = "quant" in options
        assert isinstance(eng.params["layers"]["wq"], tq.QTensor) == quantized
        assert isinstance(eng.params["embed"], tq.QTensor) == quantized
        if options.get("synthetic") and quantized:
            assert (eng.params["lm_head"].scale == teq.SYNTHETIC_SCALE).all()
        out = run(eng.generate("int8 on the cpu", max_tokens=5, ignore_eos=True))
        assert out["completion_tokens"] == 5
    finally:
        eng.shutdown()


def test_create_quant_equals_quantized_random_init():
    """``quant`` from random init equals ``quantize_params`` of the plain
    engine's weights from the same seed, leaf for leaf."""
    opts = {"device": "cpu", "max_batch": 1, "max_seq": 64, "skip_warmup": True, "seed": 3}
    dense = TEngine.create("tiny", options=opts)
    q = TEngine.create("tiny", options={**opts, "quant": "int8"})
    try:
        want = teq.quantize_params(dense.params, torch.float32)
        for (name, w), (gname, g) in zip(_flat(want), _flat(q.params)):
            assert name == gname
            if isinstance(w, tq.QTensor):
                assert torch.equal(w.q, g.q) and torch.equal(w.scale, g.scale), name
            else:
                assert torch.equal(w, g), name
    finally:
        dense.shutdown()
        q.shutdown()


# -- synthetic weights and footprints ---------------------------------------


def _shapes(tree) -> dict:
    """name → 'shape dtype' of each leaf ('q ... | scale ...' for int8)."""

    def desc(x):
        return f"{tuple(x.shape)} {str(x.dtype).removeprefix('torch.')}"

    return {
        name: f"q {desc(leaf.q)} | scale {desc(leaf.scale)}"
        if getattr(leaf, "_fields", None) == ("q", "scale") else desc(leaf)
        for name, leaf in _flat(tree)
    }


@pytest.mark.parametrize("name", ["tiny", "llama3-8b"])
def test_synthetic_tree_has_the_reference_shapes(name):
    jcfg, tcfg = jconfigs.get_config(name), tconfigs.get_config(name)
    want = jax.eval_shape(lambda: jeq.synthetic_quantized_params(jcfg, jnp.bfloat16))
    got = teq.synthetic_quantized_params(tcfg, torch.bfloat16, device="meta")
    assert _shapes(got) == _shapes(want)


def test_synthetic_llama3_8b_footprint_is_the_reference_int8_tree():
    cfg = tconfigs.get_config("llama3-8b")
    want = jax.eval_shape(lambda: jeq.synthetic_quantized_params(jconfigs.get_config("llama3-8b")))
    want_bytes = sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(want))
    got = teq.synthetic_quantized_params(cfg, torch.bfloat16, device="meta")
    assert teq.param_bytes_actual(got) == want_bytes == 8_033_544_704


def test_synthetic_values_range_scale_and_seed():
    cfg = tconfigs.get_config("tiny")

    def draw(seed):
        return teq.synthetic_quantized_params(cfg, torch.float32, "cpu", torch.Generator().manual_seed(seed))

    a, b, c = draw(0), draw(0), draw(1)
    for name, leaf in _flat(a):
        if isinstance(leaf, tq.QTensor):
            assert leaf.q.dtype == torch.int8, name
            assert int(leaf.q.min()) >= -127 and int(leaf.q.max()) <= 127, name
            assert (leaf.scale == np.float32(0.02 / 127.0)).all(), name
            assert torch.equal(leaf.q, dict(_flat(b))[name].q), name
        else:
            assert (leaf == 1).all(), name
    assert not torch.equal(a["layers"]["wq"].q, c["layers"]["wq"].q)
    # the draw covers the range: both ends appear in the embedding table
    assert int(a["embed"].q.min()) == -127 and int(a["embed"].q.max()) == 127


def test_param_bytes_actual_matches_the_reference():
    jp = jax.tree.map(np.asarray, _tiny_jax_params(jnp.bfloat16))
    jqp = jeq.quantize_params(jp)
    tqp = teq.quantize_params(params_from_numpy(jp, dtype=torch.float32), torch.bfloat16)
    assert teq.param_bytes_actual(tqp) == jeq.param_bytes_actual(jqp)
    dense = params_from_numpy(jp, dtype=torch.bfloat16)
    assert teq.param_bytes_actual(tqp) < 0.62 * teq.param_bytes_actual(dense)


# -- the quantized checkpoint load ----------------------------------------------


@pytest.mark.parametrize("tied,dtype", [(False, "F32"), (True, "BF16"), (False, "BF16")])
def test_quantized_hf_load_bit_equal(tmp_path, tied, dtype):
    cfg = tconfigs.get_config("tiny")
    write_hf(tmp_path, cfg, tied=tied, dtype=dtype, shards=2 if tied else 1)
    dense = jhf.load_hf_params(jconfigs.get_config("tiny"), tmp_path, dtype=jnp.float32)
    want = jeq.quantize_params(jax.tree.map(np.asarray, dense), dtype=jnp.float32)
    stats = {}
    got = thf.load_hf_params(cfg, tmp_path, dtype=torch.float32, device="cpu", stats=stats, quant="int8")
    _assert_tree_equal(got, want)
    assert stats["bytes_read"] > 0


def test_quantized_hf_load_refuses_another_scheme(tmp_path):
    cfg = tconfigs.get_config("tiny")
    write_hf(tmp_path, cfg)
    with pytest.raises(ValueError, match="unknown quant scheme 'int4'"):
        thf.load_hf_params(cfg, tmp_path, dtype=torch.float32, quant="int4")


def test_create_quant_from_checkpoint_equals_reference_tree(tmp_path):
    """``create(checkpoint=, quant=int8)``: the engine's tree is the
    reference's quantized load."""
    cfg = tconfigs.get_config("tiny")
    write_hf(tmp_path, cfg, dtype="BF16")
    eng = TEngine.create(
        "", checkpoint=str(tmp_path),
        options={"device": "cpu", "quant": "int8", "max_batch": 1, "max_seq": 64, "skip_warmup": True},
    )
    try:
        dense = jhf.load_hf_params(jconfigs.get_config("tiny"), tmp_path, dtype=jnp.float32)
        _assert_tree_equal(eng.params, jeq.quantize_params(jax.tree.map(np.asarray, dense), jnp.float32))
    finally:
        eng.shutdown()


# -- the host tier's KV page quantization --------------------------------------


@pytest.mark.parametrize("pos,page_size", [(37, 16), (64, 16), (5, 8)])
def test_kv_page_quantization_bit_equal(pos, page_size):
    rng = np.random.default_rng(pos)
    kv = rng.standard_normal((2, pos, 2, 16)).astype(np.float32)
    kv[:, : min(pos, page_size)] = 0.0  # an all-zero first page
    jqv, js = jeq.quantize_kv_pages(kv, page_size)
    tqv, ts = teq.quantize_kv_pages(kv, page_size)
    np.testing.assert_array_equal(tqv, jqv)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(teq.dequantize_kv_pages(tqv, ts, pos), jeq.dequantize_kv_pages(jqv, js, pos))


# -- the kernel's shapes ---------------------------------------------------------


@pytest.mark.parametrize("name", ["llama3-8b", "bench-1b"])
def test_kernel_takes_every_weight_and_plans_within_k(name):
    from agentainer_tpu_torch.engine.llm import _weight_shapes

    cfg = tconfigs.get_config(name)
    for k, n in _weight_shapes(cfg):
        assert cuda_quant.supported(k, n), (k, n)
        for m in (8, 24, 40, 72, 32, 256):
            bm, splits = cuda_quant.plan(m, n, k)
            assert bm == min(b for b in cuda_quant.BLOCK_MS if b >= m) or (m > 128 and bm == 128)
            assert 1 <= splits <= k // cuda_quant.BK // cuda_quant.MIN_SPLIT_STEPS or splits == 1
            assert splits in cuda_quant.CLUSTERS_PER_WAVE
    # decode's narrow products split over a cluster of 8; a 128256-wide head does not
    assert cuda_quant.plan(8, 1024, 4096) == (8, 8)
    assert cuda_quant.plan(8, 128256, 4096) == (8, 1)


def test_card_engine_refuses_weights_the_int8_kernel_does_not_take(monkeypatch):
    from agentainer_tpu_torch.engine.llm import _engine_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = tconfigs.get_config("llama3-8b")
    assert _engine_device("cuda", cfg, quant="int8").type == "cuda"
    odd = dataclasses.replace(cfg, ffn_dim=14344)  # 14344 % 16 == 8
    assert _engine_device("cuda", odd).type == "cuda"  # dense: no int8 kernel needed
    with pytest.raises(ValueError, match="no int8 kernel"):
        _engine_device("cuda", odd, quant="int8")
    assert _engine_device("cpu", odd, quant="int8").type == "cpu"


def test_w8a16_matmul_refuses_what_the_kernel_does_not_take():
    """Checked before any build: the wrapper raises on shapes and dtypes the
    kernel does not take (a meta tensor stands in for the card's)."""
    x = torch.empty((8, 96), dtype=torch.bfloat16, device="meta")
    q = torch.empty((96, 64), dtype=torch.int8, device="meta")
    s = torch.empty((1, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_quant.w8a16_matmul(x, q, s)
    assert not cuda_quant.supported(96, 64) and cuda_quant.supported(128, 48)
    assert not cuda_quant.supported(128, 40)


def test_every_forward_runs_each_weight_product_through_the_int8_path(monkeypatch):
    """An int8 engine with the default features (prefix cache, speculation):
    the int8 product runs 7 times per layer plus once for lm_head in every
    forward, and the forwards are the prefill chunks, the decode steps of
    every chunk and the verify rounds that /metrics counts (the count the
    card's smoke gates the kernel's launches on)."""
    calls = []
    real = tq.w8a16_matmul

    def counting(x, q, scale):
        calls.append(tuple(q.shape))
        return real(x, q, scale)

    eng = TEngine.create("tiny", options={
        "device": "cpu", "quant": "int8", "max_batch": 4, "max_seq": 512, "prefill_chunk": 64,
        "system_prompt": "You are a careful assistant.",
    })
    try:
        m0 = eng.metrics()
        monkeypatch.setattr(tq, "w8a16_matmul", counting)

        async def traffic():
            return await asyncio.gather(
                eng.generate("a" * 200, max_tokens=40),  # one repeated byte: verify rounds
                eng.chat("s1", "a plain request", max_tokens=21, ignore_eos=True),
                eng.generate("sampled " * 3, max_tokens=13, temperature=1.0, ignore_eos=True),
            )

        run(traffic())
        monkeypatch.setattr(tq, "w8a16_matmul", real)
        m1 = eng.metrics()
    finally:
        eng.shutdown()
    h0, h1 = m0["decode_chunk_hist"], m1["decode_chunk_hist"]
    forwards = (
        m1["prefill_chunks"] - m0["prefill_chunks"]
        + sum(int(c) * (n - h0.get(c, 0)) for c, n in h1.items())
        + m1["spec_rounds"] - m0["spec_rounds"]
    )
    cfg = tconfigs.get_config("tiny")
    assert m1["spec_rounds"] > m0["spec_rounds"] and forwards > 0
    assert len(calls) == (7 * cfg.n_layers + 1) * forwards
    assert calls.count((cfg.dim, cfg.vocab_size)) == forwards  # lm_head once per forward
