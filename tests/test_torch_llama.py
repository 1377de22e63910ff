"""The port's Llama forward pass against the JAX model.

Weights come from the JAX ``init_params`` and are carried over by
``params_from_numpy``; logits are compared in f32 at rtol = atol = 2e-5
(the kernel-test tolerance of tests/test_pallas_attention.py: both sides
compute the same f32 math with different summation orders). Greedy tokens
must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentainer_tpu.models import configs as jconfigs
from agentainer_tpu.models import llama as jl
from agentainer_tpu_torch.models import configs as tconfigs
from agentainer_tpu_torch.models import llama as tl
from agentainer_tpu_torch.models.convert import params_from_numpy

TOL = 2e-5
# unregistered, test-only config with a kernel-shaped head (head_dim 128)
HD128 = dict(
    name="test-hd128", vocab_size=300, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
    ffn_dim=512, max_seq_len=256, rope_theta=10_000.0,
)


def _configs(name):
    if name == "tiny":
        return jconfigs.get_config("tiny"), tconfigs.get_config("tiny")
    return jconfigs.ModelConfig(**HD128), tconfigs.ModelConfig(**HD128)


@pytest.fixture(scope="module", params=["tiny", "hd128"])
def model(request):
    jcfg, tcfg = _configs(request.param)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def _inputs(cfg, b, t, offsets, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    pos = (np.asarray(offsets, np.int32)[:, None] + np.arange(t, dtype=np.int32)[None]).astype(np.int32)
    return toks, pos


def test_registries_match():
    assert tconfigs.list_configs() == jconfigs.list_configs()
    for name in jconfigs.list_configs():
        j, t = jconfigs.get_config(name), tconfigs.get_config(name)
        assert {f: getattr(t, f) for f in t.__dataclass_fields__} == {
            f: getattr(j, f) for f in j.__dataclass_fields__
        }
        assert t.param_count() == j.param_count()
        assert t.flops_per_token(100) == j.flops_per_token(100)


def test_forward_no_cache_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    toks, pos = _inputs(jcfg, 2, 12, [0, 0])
    want, _ = jl.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    with torch.no_grad():
        got = tl.forward(tp, tcfg, torch.from_numpy(toks).long(), torch.from_numpy(pos))
    assert got.dtype == torch.float32 and got.shape == (2, 12, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_forward_with_cache_matches_jax(model):
    """Ragged cached prefill (two rows at their own offsets), then one decode
    step over the written arena; logits and arena contents both match."""
    jcfg, tcfg, jp, tp = model
    s = 48
    toks, pos = _inputs(jcfg, 2, 10, [0, 20], seed=1)
    jc = jl.KVCache.create(jcfg, 2, s, dtype=jnp.float32)
    tc = tl.KVCache.create(tcfg, 2, s, dtype=torch.float32)
    want, jc = jl.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos), jc)
    with torch.no_grad():
        got = tl.forward(tp, tcfg, torch.from_numpy(toks).long(), torch.from_numpy(pos), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=TOL, atol=TOL)

    nxt, npos = toks[:, -1:], pos[:, -1:] + 1
    want, _ = jl.forward(jp, jcfg, jnp.asarray(nxt), jnp.asarray(npos), jc)
    with torch.no_grad():
        got = tl.forward(tp, tcfg, torch.from_numpy(nxt).long(), torch.from_numpy(npos), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_prefill_padded_past_the_arena(model):
    """A chunk whose bucket padding runs past the arena end: JAX drops the
    out-of-range K/V writes; the port must drop them too instead of
    raising, and leave the arena identical."""
    jcfg, tcfg, jp, tp = model
    s = 40
    toks, pos = _inputs(jcfg, 1, 32, [20], seed=2)  # positions 20..51, arena 0..39
    toks[:, 12:] = 0  # bucket padding past the 12 real tokens
    jc = jl.KVCache.create(jcfg, 1, s, dtype=jnp.float32)
    tc = tl.KVCache.create(tcfg, 1, s, dtype=torch.float32)
    want, jc = jl.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos), jc)
    with torch.no_grad():
        got = tl.forward(tp, tcfg, torch.from_numpy(toks).long(), torch.from_numpy(pos), tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), rtol=TOL, atol=TOL)


def test_greedy_decode_tokens_match_jax(model):
    jcfg, tcfg, jp, tp = model
    toks, _ = _inputs(jcfg, 2, 5, [0, 0], seed=3)
    want = jl.greedy_decode(jp, jcfg, jnp.asarray(toks), 8, 32, dtype=jnp.float32)
    got = tl.greedy_decode(tp, tcfg, torch.from_numpy(toks).long(), 8, 32, dtype=torch.float32)
    assert got.tolist() == np.asarray(want).tolist()


def test_init_params_tree_matches_jax():
    """Same tree, shapes and dtype as the reference init (values differ:
    the port draws from a torch generator)."""
    jcfg, tcfg = _configs("tiny")
    g = torch.Generator()
    g.manual_seed(0)
    tp = tl.init_params(tcfg, g, dtype=torch.float32)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    jshapes = jax.tree.map(lambda x: tuple(x.shape), jp)
    tshapes = {
        k: ({kk: tuple(vv.shape) for kk, vv in v.items()} if isinstance(v, dict) else tuple(v.shape))
        for k, v in tp.items()
    }
    assert tshapes == jshapes
    assert 0.015 < tp["lm_head"].std().item() < 0.025
