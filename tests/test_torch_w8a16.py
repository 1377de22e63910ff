"""The int8-weight GEMM's plan and arithmetic on the CPU.

``csrc/w8a16_gemm.cu`` runs only on the card; what can be held here is what
surrounds it, on inputs made with numpy from a seed:

- ``plan`` and the grid the kernel derives from it (``w8a16_grouped_kernel``
  at E = 1: grid ``(splits, ceil(N / 128), ceil(M / BM))``, split s over contraction
  tiles ``[s * steps / splits, (s + 1) * steps / splits)``, a tile's splits
  summed in rank order), for every (K, N) of llama3-8b and bench-1b at
  M in {1, 8, 9, 24, 32, 40, 64, 72, 255, 256, 300}: every output element and
  every contraction tile is covered exactly once, the splits stay within
  one cluster and one wave, the token tile fills the most of one wave, and
  nothing of it depends on the card;
- the kernel's widening of int8 to bf16 (``widen_i8x4``: a byte permute,
  the 2^23 magic subtraction, the high half of the f32), written out in
  numpy, gives every one of the 256 int8 values its exact bf16 in each
  byte lane;
- the split sum in rank order, emulated in f32, against the plain version
  within the card's tolerance (one bf16 rounding);
- ``qmatmul``'s plain path against ``x @ dequant(w)`` in JAX at the verify
  and prefill row counts (M = 24, 72, 256), f32 within 2e-5;
- the grouped kernel's grid (``w8a16_grouped_kernel``: ``blockIdx.z = e *
  ceil(M / BM) + i``, expert e's weight tiles at row ``e * K + k0`` of the
  ``[E * K, N]`` map, a per-expert x tile at row ``e * M + m0`` of the
  ``[E * M, K]`` map) at Mixtral-8x7B's expert stacks for E = 1, 4, 8:
  every output of every expert once, no weight tile across experts, and the
  x rows a tile reads past its expert's M feeding only rows never stored —
  emulated block by block in numpy against the plain version.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from agentainer_tpu.ops import quant as jq
from agentainer_tpu_torch.engine.llm import _weight_shapes
from agentainer_tpu_torch.models import configs as tconfigs
from agentainer_tpu_torch.ops import cuda_quant
from agentainer_tpu_torch.ops import quant as tq

TOL = 2e-5  # f32, the repo's kernel tolerance
# the card's tolerance of the kernel against plain: one bf16 rounding plus
# the f32 sum-order error
W8_RTOL, W8_ATOL = 2.0**-7, 1e-4
MS = (1, 8, 9, 24, 32, 40, 64, 72, 255, 256, 300)
KN = sorted({kn for name in ("llama3-8b", "bench-1b") for kn in _weight_shapes(tconfigs.get_config(name))})


def _grid(m: int, n: int, k: int):
    """The kernel's blocks for ``plan(m, n, k)``: per block (split, column
    tile, token tile), its token rows, output channels and contraction tiles,
    as ``w8a16_grouped_kernel`` derives them from its block index at E = 1."""
    bm, splits = cuda_quant.plan(m, n, k)
    steps = k // cuda_quant.BK
    blocks = []
    for z in range(-(-m // bm)):
        for y in range(-(-n // cuda_quant.BN)):
            for s in range(splits):
                blocks.append((
                    (s, y, z),
                    range(z * bm, min(m, (z + 1) * bm)),
                    range(y * cuda_quant.BN, min(n, (y + 1) * cuda_quant.BN)),
                    range(steps * s // splits, steps * (s + 1) // splits),
                ))
    return bm, splits, blocks


def _partition(ranges, end: int) -> bool:
    """The distinct ranges tile [0, end) with no gap and no overlap."""
    spans = sorted({(r.start, r.stop) for r in ranges})
    return spans[0][0] == 0 and spans[-1][1] == end and all(
        a[1] == b[0] and a[0] < a[1] for a, b in zip(spans, spans[1:] + [(end, end)])
    )


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("k,n", KN)
def test_plan_covers_every_output_and_contraction_tile_once(k, n, m):
    assert cuda_quant.supported(k, n)
    bm, splits, blocks = _grid(m, n, k)
    steps = k // cuda_quant.BK
    # the token tile: the smallest that holds m up to 128 rows; beyond,
    # 256 or 128 rows, whichever fills more of one wave of blocks
    if m <= 128:
        assert bm == min(b for b in cuda_quant.BLOCK_MS if b >= m)
    else:
        assert bm in (128, 256)
        wave = cuda_quant.CLUSTERS_PER_WAVE[1]
        count = {
            b: -(-m // b) * -(-n // cuda_quant.BN) * cuda_quant._splits(-(-m // b) * -(-n // cuda_quant.BN), k)
            for b in (128, 256)
        }
        fitting = [b for b in count if count[b] <= wave]
        if fitting:
            assert count[bm] <= wave and count[bm] == max(count[b] for b in fitting)
        else:
            assert count[bm] == min(count.values())
    assert bm % 8 == 0 and bm <= 256  # a wgmma width
    # the splits of a tile are one cluster, at most 8 blocks
    assert splits in cuda_quant.CLUSTERS_PER_WAVE and splits <= steps
    tiles = -(-m // bm) * -(-n // cuda_quant.BN)
    if splits > 1:  # split only while the clusters fit one wave, never thinner than 4 tiles
        assert tiles <= cuda_quant.CLUSTERS_PER_WAVE[splits]
        assert steps // splits >= cuda_quant.MIN_SPLIT_STEPS
    # and no larger split would have fitted
    bigger = [s for s in cuda_quant.CLUSTERS_PER_WAVE if s > splits]
    assert not any(
        tiles <= cuda_quant.CLUSTERS_PER_WAVE[s] and steps // s >= cuda_quant.MIN_SPLIT_STEPS for s in bigger
    )
    # the product of the three partitions, each block once: every output
    # element and every contraction tile of it exactly once
    assert len({b[0] for b in blocks}) == len(blocks) == tiles * splits
    assert _partition([b[1] for b in blocks], m)
    assert _partition([b[2] for b in blocks], n)
    assert _partition([b[3] for b in blocks], steps)
    sizes = {len(b[3]) for b in blocks}
    assert max(sizes) - min(sizes) <= 1  # equal shares of the contraction


@pytest.mark.parametrize("k,n", KN)
def test_plan_depends_on_the_shape_alone(k, n, monkeypatch):
    """The plan (and with it the sum order, so the result's bits) is a
    function of (M, N, K): the same with the card's properties out of
    reach, and the same when computed afresh."""
    want = {m: cuda_quant.plan(m, n, k) for m in MS}

    def no_card(*args, **kwargs):
        raise AssertionError("the plan asked the card")

    for name in ("get_device_properties", "get_device_capability", "device_count", "is_available"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    cuda_quant.plan.cache_clear()
    assert {m: cuda_quant.plan(m, n, k) for m in MS} == want
    # the rank order of the splits: split s's partial is the s-th term
    bm, splits, blocks = _grid(max(MS), n, k)
    assert [b[0][0] for b in blocks[:splits]] == list(range(splits))


def _widen_i8x4(word: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``widen_i8x4`` of ``csrc/w8a16_gemm.cu`` on uint32 words, in numpy:
    (even, odd) bf16 pairs of bytes (0, 2) and (1, 3), low half first."""

    def byte_perm(a, b, sel):  # CUDA __byte_perm: byte i of the result is byte sel_i of (b:a)
        both = (b.astype(np.uint64) << np.uint64(32)) | a.astype(np.uint64)
        out = np.zeros_like(a, dtype=np.uint32)
        for i in range(4):
            src = (sel >> (4 * i)) & 0x7
            out |= (((both >> np.uint64(8 * src)) & np.uint64(0xFF)).astype(np.uint32)) << np.uint32(8 * i)
        return out

    u = word ^ np.uint32(0x80808080)
    two23 = np.full_like(u, 0x4B000000)
    f = [byte_perm(u, two23, 0x7650 + i).view(np.float32) - np.float32(8388736.0) for i in range(4)]
    even = byte_perm(f[0].view(np.uint32), f[2].view(np.uint32), 0x7632)
    odd = byte_perm(f[1].view(np.uint32), f[3].view(np.uint32), 0x7632)
    return even, odd


@pytest.mark.parametrize("lane", range(4))
def test_widening_gives_every_int8_its_exact_bf16(lane):
    """All 256 int8 values in byte ``lane`` of a word (the other bytes
    random) widen to exactly their bf16, in the half the fragment wants."""
    rng = np.random.default_rng(lane)
    values = np.arange(-128, 128, dtype=np.int8)
    words = rng.integers(0, 2**32, size=256, dtype=np.uint64).astype(np.uint32)
    mask = np.uint32(0xFF << (8 * lane))
    words = (words & ~mask) | (values.view(np.uint8).astype(np.uint32) << np.uint32(8 * lane))
    even, odd = _widen_i8x4(words)
    pair = even if lane % 2 == 0 else odd
    half = (pair >> np.uint32(16 * (lane // 2))) & np.uint32(0xFFFF)
    want = values.astype(np.float32).astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(half.astype(np.uint16), want)
    # and every byte of every word, each in its own half
    all_bytes = words.view(np.uint8).reshape(-1, 4).view(np.int8)
    for b, (p, h) in enumerate(((even, 0), (odd, 0), (even, 1), (odd, 1))):
        got = ((p >> np.uint32(16 * h)) & np.uint32(0xFFFF)).astype(np.uint16)
        np.testing.assert_array_equal(got, all_bytes[:, b].astype(np.float32).astype(ml_dtypes.bfloat16).view(np.uint16))


def _split_sum(x: np.ndarray, q: np.ndarray, scale: np.ndarray, splits: int) -> np.ndarray:
    """The kernel's arithmetic at ``splits``: f32 partial products over each
    split's contraction tiles, summed in rank order from zero, scaled once,
    rounded once to bf16."""
    steps = q.shape[0] // cuda_quant.BK
    acc = np.zeros((x.shape[0], q.shape[1]), dtype=np.float32)
    for s in range(splits):
        lo, hi = steps * s // splits * cuda_quant.BK, steps * (s + 1) // splits * cuda_quant.BK
        acc = acc + x[:, lo:hi] @ q[lo:hi].astype(np.float32)
    return (acc * scale).astype(ml_dtypes.bfloat16).astype(np.float32)


@pytest.mark.parametrize("m,k,n", [(8, 1024, 128), (24, 2048, 256), (72, 512, 384), (256, 1024, 128)])
def test_split_sum_in_rank_order_holds_the_plain_version(m, k, n):
    rng = np.random.default_rng(m + k)
    x = rng.standard_normal((m, k)).astype(ml_dtypes.bfloat16).astype(np.float32)
    q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = ((0.5 + rng.random((1, n))) * (0.02 / 127.0)).astype(ml_dtypes.bfloat16).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    st = torch.from_numpy(scale).to(torch.bfloat16)
    want = cuda_quant.w8a16_matmul_plain(xt, torch.from_numpy(q), st).float().numpy()
    for splits in range(1, 9):
        got = _split_sum(x, q, scale, splits)
        np.testing.assert_allclose(got, want, rtol=W8_RTOL, atol=W8_ATOL, err_msg=f"splits={splits}")


@pytest.mark.parametrize("m", [24, 72, 256])
def test_qmatmul_plain_matches_jax_at_verify_and_prefill_rows(m):
    rng = np.random.default_rng(m)
    w = rng.standard_normal((128, 48)).astype(np.float32) * 0.02
    w[:, 5] *= 30.0  # an outlier channel
    x = rng.standard_normal((m, 128)).astype(np.float32)
    want = jnp.asarray(x) @ jq.dequant(jq.quantize_array(w, jnp.float32))
    got = tq.qmatmul(torch.from_numpy(x), tq.quantize_array(w, torch.float32))
    assert tuple(got.shape) == (m, 48) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


# -- the grouped expert GEMM ------------------------------------------------------

MIXTRAL_KN = ((4096, 14336), (14336, 4096))  # gate/up and down of each expert


def _grouped_grid(e: int, m: int, n: int, k: int, per_expert: bool):
    """The grouped kernel's blocks for ``plan(m, n, k, e)``: per block its
    expert, the rows it stores, its output channels, the q rows and the x
    rows of its map that it reads, as ``w8a16_grouped_kernel`` derives them."""
    bm, splits = cuda_quant.plan(m, n, k, e)
    m_tiles, steps = -(-m // bm), k // cuda_quant.BK
    blocks = []
    for z in range(e * m_tiles):
        ex, m0 = z // m_tiles, (z % m_tiles) * bm
        x0 = ex * m + m0 if per_expert else m0
        for y in range(-(-n // cuda_quant.BN)):
            for sp in range(splits):
                s0, s1 = steps * sp // splits, steps * (sp + 1) // splits
                blocks.append(dict(
                    expert=ex, rows=range(m0, min(m, m0 + bm)),
                    cols=range(y * cuda_quant.BN, min(n, (y + 1) * cuda_quant.BN)),
                    q_rows=range(ex * k + s0 * cuda_quant.BK, ex * k + s1 * cuda_quant.BK),
                    x_rows=range(x0, x0 + bm), m0=m0,
                ))
    return bm, splits, blocks


@pytest.mark.parametrize("per_expert", [False, True], ids=["shared_x", "per_expert_x"])
@pytest.mark.parametrize("e", [1, 4, 8])
@pytest.mark.parametrize("k,n", MIXTRAL_KN)
def test_grouped_plan_covers_every_expert_output_once(k, n, e, per_expert):
    for m in MS:
        bm, splits, blocks = _grouped_grid(e, m, n, k, per_expert)
        assert (bm, splits) == cuda_quant.plan(m, n, k, e)
        if e == 1:
            assert (bm, splits) == cuda_quant.plan(m, n, k)
        assert e * -(-m // bm) <= 65535  # gridDim.z
        seen = {}
        for b in blocks:
            # a weight tile never leaves its expert's K rows of the stack
            assert b["expert"] * k <= b["q_rows"].start < b["q_rows"].stop <= (b["expert"] + 1) * k
            for r in b["rows"]:
                # a stored row's x is its expert's row r (shared x: row r)
                assert b["x_rows"][r - b["m0"]] == (b["expert"] * m + r if per_expert else r)
                key = (b["expert"], r, b["cols"].start)
                seen[key] = seen.get(key, 0) + len(b["q_rows"])
        # every (expert, row, column tile) once, over the whole contraction
        assert len(seen) == e * m * -(-n // cuda_quant.BN)
        assert set(seen.values()) == {k}


@pytest.mark.parametrize("m", [1, 9, 13, 32, 64])
def test_grouped_blocks_reading_past_m_store_the_plain_result(m):
    """The kernel's blocks emulated in numpy on a small stack (E = 3, K =
    128, N = 48, per-expert x): each block multiplies the x rows its map
    gives it (past its expert's M, the next expert's rows or TMA's zeros)
    and stores rows < M only; the stores equal the plain version."""
    e, k, n = 3, 128, 48
    rng = np.random.default_rng(m)
    x = rng.standard_normal((e, m, k)).astype(np.float32)
    q = rng.integers(-127, 128, (e, k, n)).astype(np.int8)
    scale = (rng.random((e, 1, n)) * 1e-3).astype(np.float32)
    flat_x, flat_q = x.reshape(e * m, k), q.reshape(e * k, n).astype(np.float32)
    bm, splits, blocks = _grouped_grid(e, m, n, k, per_expert=True)
    out = np.full((e, m, n), np.nan, np.float32)
    for b in blocks:
        rows = [r if r < e * m else None for r in b["x_rows"]]  # past the map: zeros
        tile = np.stack([flat_x[r] if r is not None else np.zeros(k, np.float32) for r in rows])
        part = tile[:, [c % k for c in range(b["q_rows"].start, b["q_rows"].stop)]] @ flat_q[b["q_rows"]]
        for i, r in enumerate(b["rows"]):
            cur = out[b["expert"], r, b["cols"]]
            cur = np.where(np.isnan(cur), 0.0, cur)
            out[b["expert"], r, b["cols"]] = cur + part[i, b["cols"]]
    assert not np.isnan(out).any()
    got = out * scale
    want = cuda_quant.w8a16_matmul_plain(
        torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(scale)
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
