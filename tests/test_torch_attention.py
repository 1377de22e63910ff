"""The port's flash attention against the JAX Pallas kernels.

On CPU tensors the port's ``flash_prefill`` / ``flash_decode`` wrappers run
their plain PyTorch versions; here they are held against the JAX kernels in
interpret mode and against the JAX ``attention_reference`` + ``cache_mask``
pair, case for case with the dense cases of tests/test_pallas_attention.py.
Tolerances as there: f32 rtol = atol = 2e-5, bf16 3e-2. The CUDA kernels
themselves are held against the same plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import importlib.util
import os
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


def _split_decode_model(q, k, v, pos, split_len):
    """Plain model of the CUDA decode's split-and-merge rule: ``decode_kernel``
    (csrc/flash_attention.cu) writes f32 (m, l, acc) for every split of
    ``split_len`` slots that starts at or before min(pos, S - 1), and
    ``decode_combine_kernel`` merges the live splits in split order; a lane
    with no live split (pos < 0) gives zeros. q [B, H, hd] → [B, H, hd]."""
    b, h, hd = q.shape
    s_len, kv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, kv, h // kv, hd)
    out = torch.zeros(b, kv, h // kv, hd)
    for i in range(b):
        last = min(int(pos[i]), s_len - 1)
        parts = []  # (m, l, acc) per live split, in split order
        for s0 in range(0, last + 1, split_len):
            sl = slice(s0, min(s0 + split_len, last + 1))
            scores = torch.einsum("kgd,nkd->kgn", qg[i], k[i, sl].float()) / hd**0.5
            m = scores.amax(-1)
            p = torch.exp(scores - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("kgn,nkd->kgd", p, v[i, sl].float())))
        if not parts:
            continue
        mm = torch.stack([m for m, _, _ in parts]).amax(0)
        l = acc = 0
        for m, li, ai in parts:
            f = torch.exp(m - mm)
            l, acc = l + li * f, acc + ai * f[..., None]
        out[i] = acc / torch.where(l == 0, torch.ones_like(l), l)[..., None]
    return out.reshape(b, h, hd).to(q.dtype)


@pytest.mark.parametrize("split_len", [64, 256])
def test_split_decode_merge_matches_jax_and_plain(split_len):
    """The split-and-merge rule of the CUDA decode equals one pass over the
    arena: positions -1 and 0, either side of a split boundary, a lane
    whose later splits are wholly past its position, the arena's last slot,
    and a position past the arena. f32, 2e-5."""
    b, heads, kv_heads, hd, s = 8, 8, 2, 128, 600  # the last split is partial
    L = split_len
    rng = np.random.default_rng(11)
    q, ck, cv = _rand(rng, b, heads, hd), _rand(rng, b, s, kv_heads, hd), _rand(rng, b, s, kv_heads, hd)
    pos = np.array([-1, 0, L - 1, L, L + 1, 2 * L + 3, s - 1, s + 7], np.int32)
    got = _split_decode_model(_t(q), _t(ck), _t(cv), _t(pos), split_len)
    assert torch.count_nonzero(got[0]) == 0
    _close(got, jpa.flash_decode(q, ck, cv, pos, interpret=True), F32)
    _close(got, tca.flash_decode_plain(_t(q), _t(ck), _t(cv), _t(pos)), F32)


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # standard library only at import
    return mod


def test_bf16_p_rounding_error_at_the_served_prefill_shape():
    """The tensor-core prefill rounds P to bf16 before P·V (the A operand of
    the mma); the plain version keeps P in f32. At the served chunk (q
    [1, 256, 32, 128], arena 2048, positions 300..555, bf16-valued inputs)
    that adds up to ~8e-4 absolute error to outputs of |o| <= ~1: this
    figure is the extra bf16 tolerance chip_smoke.py gives the prefill rows
    (``BF16_P_ATOL``) on top of one bf16 rounding."""
    b, t, heads, kv_heads, hd, s, off = 1, 256, 32, 8, 128, 2048, 300
    rng = np.random.default_rng(12)
    q, k, v = (
        _t(_rand(rng, *shape)).to(torch.bfloat16).float()
        for shape in ((b, t, heads, hd), (b, s, kv_heads, hd), (b, s, kv_heads, hd))
    )
    pos = torch.arange(off, off + t, dtype=torch.int32)[None]
    qg = q.reshape(b, t, kv_heads, heads // kv_heads, hd)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k) / hd**0.5
    visible = (torch.arange(s)[None, None, :] <= pos[:, :, None])[:, None, None]
    scores = torch.where(visible, scores, torch.full_like(scores, tca.NEG_INF))
    p = torch.where(visible, torch.exp(scores - scores.amax(-1, keepdim=True)), torch.zeros(()))
    l = p.sum(-1, keepdim=True)
    rounded = torch.einsum("bkgts,bskd->btkgd", p.bfloat16().float(), v) / l.permute(0, 3, 1, 2, 4)
    plain = tca.flash_prefill_plain(q, k, v, pos).reshape(rounded.shape)
    err = (rounded - plain).abs().max().item()
    assert 1e-4 < err <= _chip_smoke().BF16_P_ATOL, err


def test_bf16_p_rounding_error_from_position_zero():
    """At the training shape (positions 0..T-1; here 8 of the 32 heads of
    q [1, 2048, 32, 128]) the first rows see a few slots, each with a large
    weight, so rounding P to bf16 moves them by more than the served
    chunk's ``BF16_P_ATOL``. It stays within the bound chip_smoke.py's
    training check uses, 2**-9 * max|v|: P's relative rounding error is at
    most 2**-9 and a row's weights sum to 1."""
    b, t, heads, kv_heads, hd = 1, 2048, 8, 2, 128
    rng = np.random.default_rng(13)
    q, k, v = (
        _t(_rand(rng, *shape)).to(torch.bfloat16).float()
        for shape in ((b, t, heads, hd), (b, t, kv_heads, hd), (b, t, kv_heads, hd))
    )
    pos = torch.arange(t, dtype=torch.int32)[None]
    qg = q.reshape(b, t, kv_heads, heads // kv_heads, hd)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k) / hd**0.5
    visible = (torch.arange(t)[None, None, :] <= pos[:, :, None])[:, None, None]
    scores = torch.where(visible, scores, torch.full_like(scores, tca.NEG_INF))
    p = torch.where(visible, torch.exp(scores - scores.amax(-1, keepdim=True)), torch.zeros(()))
    l = p.sum(-1, keepdim=True)
    rounded = torch.einsum("bkgts,bskd->btkgd", p.bfloat16().float(), v) / l.permute(0, 3, 1, 2, 4)
    plain = tca.flash_prefill_plain(q, k, v, pos).reshape(rounded.shape)
    err = (rounded - plain).abs().max().item()
    assert _chip_smoke().BF16_P_ATOL < err <= 2.0**-9 * v.abs().max().item(), err


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
