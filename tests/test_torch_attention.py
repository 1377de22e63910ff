"""The port's flash attention against the JAX Pallas kernels.

On CPU tensors the port's ``flash_prefill`` / ``flash_decode`` wrappers run
their plain PyTorch versions; here they are held against the JAX kernels in
interpret mode and against the JAX ``attention_reference`` + ``cache_mask``
pair, case for case with the dense cases of tests/test_pallas_attention.py.
Tolerances as there: f32 rtol = atol = 2e-5, bf16 3e-2. The CUDA kernels
themselves are held against the same plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agentainer_tpu.ops import attention as jatt
from agentainer_tpu.ops import pallas_attention as jpa
from agentainer_tpu_torch.ops import attention as tatt
from agentainer_tpu_torch.ops import cuda_attention as tca

F32, BF16 = 2e-5, 3e-2


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), rtol=tol, atol=tol
    )


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


@pytest.mark.parametrize("heads,kv_heads", [(4, 2), (2, 2), (8, 1)])
def test_prefill_causal_matches_jax(heads, kv_heads):
    b, t, hd = 2, 40, 128
    rng = np.random.default_rng(0)
    q, k, v = _rand(rng, b, t, heads, hd), _rand(rng, b, t, kv_heads, hd), _rand(rng, b, t, kv_heads, hd)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t))
    got = tca.flash_prefill(_t(q), _t(k), _t(v), _t(pos))
    _close(got, jpa.flash_prefill(q, k, v, pos, interpret=True), F32)
    mask = jnp.broadcast_to(jatt.causal_mask(t), (b, t, t))
    _close(got, jatt.attention_reference(q, k, v, mask=mask), F32)
    # the no-cache causal entry (reference: flash_attention_tpu)
    _close(tca.flash_attention_causal(_t(q), _t(k), _t(v)), jatt.attention_reference(q, k, v, mask=mask), F32)


def test_prefill_cached_ragged_positions():
    """Each sequence prefills at its own offset into a shared arena whose
    length is not a multiple of the TPU kernel's KV block."""
    b, t, heads, kv_heads, hd, s = 3, 16, 4, 2, 128, 384
    rng = np.random.default_rng(1)
    q, ck, cv = _rand(rng, b, t, heads, hd), _rand(rng, b, s, kv_heads, hd), _rand(rng, b, s, kv_heads, hd)
    pos = (np.array([0, 77, 300], np.int32)[:, None] + np.arange(t, dtype=np.int32)[None]).astype(np.int32)
    got = tca.flash_prefill(_t(q), _t(ck), _t(cv), _t(pos))
    _close(got, jpa.flash_prefill(q, ck, cv, pos, interpret=True), F32)
    _close(got, jatt.attention_reference(q, ck, cv, mask=jatt.cache_mask(jnp.asarray(pos), s)), F32)


def test_prefill_multiple_q_blocks():
    b, t, heads, kv_heads, hd, s = 1, 320, 4, 4, 128, 320
    rng = np.random.default_rng(2)
    q, k, v = _rand(rng, b, t, heads, hd), _rand(rng, b, s, kv_heads, hd), _rand(rng, b, s, kv_heads, hd)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t))
    got = tca.flash_prefill(_t(q), _t(k), _t(v), _t(pos))
    _close(got, jpa.flash_prefill(q, k, v, pos, block_q=128, block_k=128, interpret=True), F32)
    _close(got, jatt.attention_reference(q, k, v, mask=jatt.cache_mask(jnp.asarray(pos), s)), F32)


@pytest.mark.parametrize("block_k", [128, 512])
def test_decode_matches_jax(block_k):
    b, heads, kv_heads, hd, s = 4, 4, 2, 128, 384
    rng = np.random.default_rng(3)
    q, ck, cv = _rand(rng, b, heads, hd), _rand(rng, b, s, kv_heads, hd), _rand(rng, b, s, kv_heads, hd)
    pos = np.array([0, 5, 200, 383], np.int32)
    got = tca.flash_decode(_t(q), _t(ck), _t(cv), _t(pos))
    _close(got, jpa.flash_decode(q, ck, cv, pos, block_k=block_k, interpret=True), F32)
    want = jatt.attention_reference(q[:, None], ck, cv, mask=jatt.cache_mask(jnp.asarray(pos)[:, None], s))[:, 0]
    _close(got, want, F32)


def test_decode_bf16():
    b, heads, kv_heads, hd, s = 2, 4, 2, 128, 256
    rng = np.random.default_rng(4)
    q, ck, cv = _rand(rng, b, heads, hd), _rand(rng, b, s, kv_heads, hd), _rand(rng, b, s, kv_heads, hd)
    pos = np.array([31, 255], np.int32)
    got = tca.flash_decode(*(_t(x).to(torch.bfloat16) for x in (q, ck, cv)), _t(pos))
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, ck, cv))
    _close(got, jpa.flash_decode(jq, jk, jv, pos, interpret=True).astype(jnp.float32), BF16)
    want = jatt.attention_reference(jq[:, None], jk, jv, mask=jatt.cache_mask(jnp.asarray(pos)[:, None], s))[:, 0]
    _close(got, want.astype(jnp.float32), BF16)


def test_prefill_bf16():
    b, t, heads, kv_heads, hd, s = 2, 24, 8, 2, 128, 256
    rng = np.random.default_rng(5)
    q, ck, cv = _rand(rng, b, t, heads, hd), _rand(rng, b, s, kv_heads, hd), _rand(rng, b, s, kv_heads, hd)
    pos = (np.array([3, 200], np.int32)[:, None] + np.arange(t, dtype=np.int32)[None]).astype(np.int32)
    got = tca.flash_prefill(*(_t(x).to(torch.bfloat16) for x in (q, ck, cv)), _t(pos))
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, ck, cv))
    _close(got, jpa.flash_prefill(jq, jk, jv, pos, interpret=True).astype(jnp.float32), BF16)


def test_plain_versions_zero_rows_without_visible_slots():
    """pos < 0 sees no slot: the kernels' l == 0 rule gives zeros (the JAX
    decode kernel does the same; a fully-masked softmax would average V)."""
    rng = np.random.default_rng(6)
    q, k, v = _rand(rng, 2, 4, 128), _rand(rng, 2, 16, 2, 128), _rand(rng, 2, 16, 2, 128)
    pos = np.array([-1, 3], np.int32)
    got = tca.flash_decode(_t(q), _t(k), _t(v), _t(pos))
    assert torch.count_nonzero(got[0]) == 0
    _close(got, jpa.flash_decode(q, k, v, pos, interpret=True), F32)


@pytest.mark.parametrize("t", [1, 6])
def test_cache_attention_dispatch_on_cpu(t):
    """CPU tensors take the plain reference path, decode (T == 1) and
    prefill alike, and agree with the JAX dispatch on the CPU."""
    b, heads, kv_heads, hd, s = 2, 4, 2, 128, 64
    rng = np.random.default_rng(7)
    q, ck, cv = _rand(rng, b, t, heads, hd), _rand(rng, b, s, kv_heads, hd), _rand(rng, b, s, kv_heads, hd)
    pos = (np.array([10, 40], np.int32)[:, None] + np.arange(t, dtype=np.int32)[None]).astype(np.int32)
    before = (tca.flash_prefill.launches, tca.flash_decode.launches)
    got = tatt.cache_attention(_t(q), _t(ck), _t(cv), _t(pos))
    assert (tca.flash_prefill.launches, tca.flash_decode.launches) == before
    _close(got, jatt.cache_attention(q, ck, cv, jnp.asarray(pos)), F32)


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU launches the kernel or raises; it is
    never sent to the plain version (a meta tensor is neither)."""
    q = torch.empty(1, 8, 4, 128, device="meta")
    kv = torch.empty(1, 16, 2, 128, device="meta")
    pos = torch.empty(1, 8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tca.flash_prefill(q, kv, kv, pos)
    with pytest.raises(ValueError):
        tca.flash_decode(q[:, 0], kv, kv, pos[:, 0])


@pytest.mark.parametrize("op", ["flash_attention", "cache_attention", "paged_cache_attention"])
def test_dispatch_off_the_cpu_raises_for_a_head_the_kernels_do_not_take(op):
    """A tensor off the CPU whose head the kernels do not take (head_dim 64)
    is refused by the kernel's wrapper; the dispatch never gives way to the
    plain reference there (a meta tensor would run it without complaint)."""
    q = torch.empty(1, 8, 4, 64, device="meta")
    kv = torch.empty(1, 16, 2, 64, device="meta")
    pos = torch.empty(1, 8, dtype=torch.int32, device="meta")
    table = torch.empty(1, 1, dtype=torch.int32, device="meta")
    calls = {
        "flash_attention": lambda: tatt.flash_attention(q, kv, kv, causal=True),
        "cache_attention": lambda: tatt.cache_attention(q, kv, kv, pos),
        "paged_cache_attention": lambda: tatt.paged_cache_attention(q, kv, kv, table, pos),
    }
    with pytest.raises(ValueError, match="unsupported shape"):
        calls[op]()


def test_kernel_supported_shapes():
    assert tca.kernel_supported(32, 8, 128)
    assert not tca.kernel_supported(4, 2, 16)  # tiny: plain path
    assert not tca.kernel_supported(32, 8, 256)
    assert not tca.kernel_supported(12, 4, 128)  # 3 query heads per kv head


def test_import_needs_no_nvcc():
    """Importing the kernel module builds nothing: a machine without the
    CUDA toolkit imports every module of the port."""
    code = (
        "import agentainer_tpu_torch.ops.cuda_attention as m;"
        "assert m._lib.cache_info().currsize == 0; print('ok')"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env={"PATH": "/nonexistent", "PYTHONPATH": ":".join(p for p in sys.path if p)},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
