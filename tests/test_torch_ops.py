"""Port ops against the JAX reference ops on identical numpy inputs.

rms_norm, rope and embed_lookup of ``agentainer_tpu_torch.ops`` vs
``agentainer_tpu.ops``. Tolerances follow tests/test_pallas_attention.py:
f32 rtol = atol = 2e-5, bf16 3e-2 (both sides round the same f32 inputs to
bf16 and compute in f32 internally, so bf16 differences are output
rounding only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentainer_tpu.ops import norms as jnorms
from agentainer_tpu.ops import quant as jquant
from agentainer_tpu.ops import rope as jrope
from agentainer_tpu_torch.ops import norms as tnorms
from agentainer_tpu_torch.ops import quant as tquant
from agentainer_tpu_torch.ops import rope as trope

DTYPES = {
    "float32": (jnp.float32, torch.float32, 2e-5),
    "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2),
}


def _both(x: np.ndarray, dtype: str):
    jd, td, _ = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _close(got_torch, want_jax, tol):
    np.testing.assert_allclose(
        got_torch.float().numpy(), np.asarray(want_jax, np.float32), rtol=tol, atol=tol
    )


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal((64,)).astype(np.float32)
    (xj, xt), (wj, wt) = _both(x, dtype), _both(w, dtype)
    got = tnorms.rms_norm(xt, wt, 1e-5)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, jnorms.rms_norm(xj, wj, 1e-5), DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_apply_rope_matches_jax(dtype, theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 2048, (2, 7)).astype(np.int32)
    xj, xt = _both(x, dtype)
    got = trope.apply_rope(xt, torch.from_numpy(pos), theta)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, jrope.apply_rope(xj, jnp.asarray(pos), theta), DTYPES[dtype][2])


def test_rope_frequencies_match_jax():
    _close(trope.rope_frequencies(128, 500_000.0), jrope.rope_frequencies(128, 500_000.0), 2e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_embed_lookup_matches_jax(dtype):
    rng = np.random.default_rng(2)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    tokens = rng.integers(0, 50, (2, 5)).astype(np.int32)
    tj, tt = _both(table, dtype)
    got = tquant.embed_lookup(tt, torch.from_numpy(tokens).long())
    _close(got, jquant.embed_lookup(tj, jnp.asarray(tokens)), DTYPES[dtype][2])


def test_dequant_matches_jax():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((2, 16, 8)).astype(np.float32)
    jq = jquant.quantize_array(w, dtype=jnp.float32)
    tq = tquant.QTensor(torch.from_numpy(np.array(jq.q)), torch.from_numpy(np.array(jq.scale)))
    _close(tquant.dequant(tq), jquant.dequant(jq), 2e-5)
    dense = torch.from_numpy(w)
    assert tquant.dequant(dense) is dense


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantized_jax_tree_round_trips_through_params_from_numpy(dtype):
    """A quantized JAX tree comes across as the port's QTensor: q stays int8
    bit for bit, scale comes into the asked dtype, dense leaves stay dense."""
    import jax

    from agentainer_tpu.engine.quant import quantize_params
    from agentainer_tpu_torch.models.convert import params_from_numpy

    rng = np.random.default_rng(4)
    tree = {
        "embed": rng.standard_normal((32, 16)).astype(np.float32),
        "layers": {
            "wq": rng.standard_normal((2, 16, 16)).astype(np.float32),
            "attn_norm": np.ones((2, 16), np.float32),
        },
    }
    jq = jax.tree.map(np.asarray, quantize_params(tree, dtype=jnp.float32))
    got = params_from_numpy(jq, dtype=DTYPES[dtype][1])
    for key, want in (("embed", jq["embed"]), ("wq", jq["layers"]["wq"])):
        leaf = got[key] if key == "embed" else got["layers"][key]
        assert type(leaf) is tquant.QTensor
        assert leaf.q.dtype == torch.int8 and leaf.scale.dtype == DTYPES[dtype][1]
        np.testing.assert_array_equal(leaf.q.numpy(), want.q)
        _close(leaf.scale, want.scale, 0.0 if dtype == "float32" else DTYPES[dtype][2])
    norm = got["layers"]["attn_norm"]
    assert isinstance(norm, torch.Tensor) and norm.dtype == DTYPES[dtype][1]
