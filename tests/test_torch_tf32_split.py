"""The arithmetic of the f32 prefill body's three-pass TF32 products,
modelled in numpy and held against the JAX Pallas kernel.

``prefill_tf32`` (csrc/flash_attention.cu) runs S = QK^T and P.V on the
tensor cores as a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, where hi is the
value rounded to the nearest tf32 (ties away from zero) by an integer add
and mask, lo = x - hi is read by the tensor cores to tf32 (its last 13 bits
dropped), and each 16-column chunk of S and each 64-slot tile of P.V is
summed apart and added in f32. The model below does that arithmetic with
exact products (the products of two tf32 values are exact in float64): the
split holds the repo's f32 tolerance (2e-5, as tests/test_pallas_attention.py
holds the Pallas kernels) against the JAX kernel in interpret mode, and one
TF32 pass misses it. The kernel itself is held against the plain version
on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from agentainer_tpu.ops import attention as jatt
from agentainer_tpu.ops import pallas_attention as jpa

F32 = 2e-5
NEG_INF = -1e30
TF32_MASK = np.uint32(0xFFFFE000)  # the 19 bits a tf32 operand keeps


def split_tf32(x):
    """f32 x -> (hi, lo) as the kernel's ``split_tf32`` gives them to the
    tensor cores: hi rounded to the nearest tf32, ties away from zero; lo =
    x - hi in f32, truncated to tf32 as the mma reads it."""
    x = np.ascontiguousarray(x, np.float32)
    hi = ((x.view(np.uint32) + np.uint32(0x1000)) & TF32_MASK).view(np.float32)
    lo = np.ascontiguousarray(x - hi).view(np.uint32) & TF32_MASK
    return hi, lo.view(np.float32)


def _products(a, b, passes):
    """sum_k a[..., k] b[k, ...] over the last axis of a and the first of b,
    as the three (or one) TF32 passes give it, exact, then rounded to f32."""
    ah, al = (x.astype(np.float64) for x in split_tf32(a))
    bh, bl = (x.astype(np.float64) for x in split_tf32(b))
    out = ah @ bh
    if passes == 3:
        out += al @ bh + ah @ bl
    return out.astype(np.float32)


def prefill_model(q, k, v, pos, passes=3):
    """q [B, T, H, hd], k/v [B, S, KV, hd], pos [B, T] -> f32 [B, T, H, hd]
    under the kernels' masking and l == 0 rules: S summed per 16-column
    chunk of head_dim and P.V per 64-slot tile, each chunk or tile added in
    f32; the softmax in f32 over the whole row (the online rescaling is the
    bf16 body's, unchanged, and tested with the kernels)."""
    b, t, h, hd = q.shape
    s_len, kv = k.shape[1], k.shape[2]
    g = h // kv
    out = np.zeros((b, t, h, hd), np.float32)
    for i in range(b):
        for head in range(h):
            kh = head // g
            s = np.zeros((t, s_len), np.float32)
            for c in range(0, hd, 16):
                s += _products(q[i, :, head, c:c + 16], k[i, :, kh, c:c + 16].T, passes)
            s *= np.float32(1.0 / np.sqrt(hd))
            visible = np.arange(s_len)[None, :] <= pos[i][:, None]
            s = np.where(visible, s, np.float32(NEG_INF))
            p = np.where(visible, np.exp(s - s.max(-1, keepdims=True)), np.float32(0)).astype(np.float32)
            o = np.zeros((t, hd), np.float32)
            for j in range(0, s_len, 64):
                o += _products(p[:, j:j + 64], v[i, j:j + 64, kh], passes)
            l = p.sum(-1, dtype=np.float32)
            out[i, :, head] = o / np.where(l == 0, np.float32(1), l)[:, None]
    return out


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_split_is_round_to_nearest_tf32_and_exact():
    """hi keeps 10 mantissa bits, rounded to nearest with ties away from
    zero (what cvt.rna.tf32.f32 gives), hi + lo is x exactly before lo's
    truncation, and lo's truncation loses under 2**-21 of x."""
    rng = np.random.default_rng(0)
    # ties: 10 mantissa bits then a lone half-ulp bit
    ties = np.float32(1) + np.arange(64, dtype=np.float32) * np.float32(2.0**-10) + np.float32(2.0**-11)
    x = np.concatenate([_rand(rng, 4096) * np.float32(1e3), _rand(rng, 4096) * np.float32(1e-3), ties, -ties])
    hi, lo = split_tf32(x)
    assert not (hi.view(np.uint32) & ~TF32_MASK).any()
    wide = x.astype(np.float64)
    ulp = np.exp2(np.floor(np.log2(np.abs(wide))) - 10)
    want = np.sign(wide) * np.floor(np.abs(wide) / ulp + 0.5) * ulp  # nearest, ties away
    np.testing.assert_array_equal(hi.astype(np.float64), want)
    exact_lo = (x - hi).astype(np.float64)
    assert np.array_equal(hi.astype(np.float64) + exact_lo, wide)
    assert (np.abs(exact_lo - lo) <= 2.0**-21 * np.abs(wide)).all()


@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (8, 2)])
def test_three_passes_hold_f32_where_one_pass_misses(heads, kv_heads):
    """Causal rows over an arena that is no multiple of 64 slots, a row
    that sees nothing (pos -1) and rows past the arena end: the three-pass
    model within 2e-5 of the JAX kernel (interpret mode) and of the JAX
    reference; the same model with one pass more than ten times off."""
    b, t, hd, s = 2, 24, 128, 100
    rng = np.random.default_rng(1)
    q, k, v = _rand(rng, b, t, heads, hd), _rand(rng, b, s, kv_heads, hd), _rand(rng, b, s, kv_heads, hd)
    pos = np.stack([np.arange(-1, t - 1), np.arange(s - 10, s - 10 + t)]).astype(np.int32)
    # row (0, 0) sees nothing: zeros by the port's l == 0 rule, where the JAX
    # prefill kernel and reference average V
    want = np.asarray(jpa.flash_prefill(q, k, v, pos, interpret=True), np.float32)[:, 1:]
    ref = np.asarray(jatt.attention_reference(q, k, v, mask=jatt.cache_mask(jnp.asarray(pos), s)))[:, 1:]
    got = prefill_model(q, k, v, pos)
    assert not got[0, 0].any()
    np.testing.assert_allclose(got[:, 1:], want, rtol=F32, atol=F32)
    np.testing.assert_allclose(got[:, 1:], ref, rtol=F32, atol=F32)
    assert np.abs(prefill_model(q, k, v, pos, passes=1)[:, 1:] - want).max() > 10 * F32


def test_three_passes_hold_f32_at_a_ring_block():
    """The ring's visiting block: every slot visible to every row."""
    b, t, heads, kv_heads, hd, s = 1, 32, 4, 2, 128, 64
    rng = np.random.default_rng(2)
    q, k, v = _rand(rng, b, t, heads, hd), _rand(rng, b, s, kv_heads, hd), _rand(rng, b, s, kv_heads, hd)
    pos = np.broadcast_to(np.arange(s, s + t, dtype=np.int32), (b, t))
    want = np.asarray(jpa.flash_prefill(q, k, v, pos, interpret=True), np.float32)
    np.testing.assert_allclose(prefill_model(q, k, v, pos), want, rtol=F32, atol=F32)
