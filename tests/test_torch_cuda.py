"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is visible (CPU CI);
on the machine with the card run ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py`` (tests/conftest.py imports jax, which that
machine does not have). The kernels build from ``csrc/`` on first use.
Tolerances: f32 2e-5 with TF32 off (stated and set in the fixture), bf16
3e-2, as tests/test_pallas_attention.py holds the Pallas kernels.
"""

import json
import time

import pytest
import torch

from agentainer_tpu_torch.analysis.contracts import no_implicit_sync
from agentainer_tpu_torch.ops import cuda_attention as ca

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


def _randn(g, dev, dtype, *shape):
    return torch.randn(shape, generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,kv_heads", [(4, 2), (2, 2), (8, 1), (32, 8)])
def test_prefill_kernel_matches_plain(dev, dtype, heads, kv_heads):
    g = torch.Generator(device=dev).manual_seed(0)
    b, t, s = 3, 70, 300
    q = _randn(g, dev, dtype, b, t, heads, 128)
    k, v = (_randn(g, dev, dtype, b, s, kv_heads, 128) for _ in range(2))
    pos = (torch.tensor([0, 77, 260], device=dev)[:, None] + torch.arange(t, device=dev)).int()
    before = ca.flash_prefill.launches
    got = ca.flash_prefill(q, k, v, pos)
    assert ca.flash_prefill.launches == before + 1
    want = ca.flash_prefill_plain(q, k, v, pos)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,kv_heads", [(4, 2), (2, 2), (8, 1), (32, 8)])
def test_decode_kernel_matches_plain(dev, dtype, heads, kv_heads):
    g = torch.Generator(device=dev).manual_seed(1)
    b, s = 5, 384
    q = _randn(g, dev, dtype, b, heads, 128)
    k, v = (_randn(g, dev, dtype, b, s, kv_heads, 128) for _ in range(2))
    pos = torch.tensor([-1, 0, 5, 200, 383], device=dev, dtype=torch.int32)
    got = ca.flash_decode(q, k, v, pos)
    want = ca.flash_decode_plain(q, k, v, pos)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


def test_kernels_read_strided_arena_views(dev):
    """The engine hands the kernels strided arena rows (a spare slot past S
    per row); they must read them in place."""
    g = torch.Generator(device=dev).manual_seed(2)
    store = _randn(g, dev, torch.bfloat16, 2, 4, 257, 2, 128)  # [2(k|v), B, S+1, KV, hd]
    k, v = store[0, :, :-1], store[1, :, :-1]
    q = _randn(g, dev, torch.bfloat16, 4, 8, 128)
    pos = torch.tensor([3, 100, 255, 256], device=dev, dtype=torch.int32)
    got = ca.flash_decode(q, k, v, pos)
    want = ca.flash_decode_plain(q, k.contiguous(), v.contiguous(), pos)
    torch.testing.assert_close(got.float(), want.float(), rtol=3e-2, atol=3e-2)


def _paged_case(g, dev, dtype, b, heads, kv_heads, ps, s):
    """Pools, a scrambled block table in which lanes 0 and 1 share a page,
    and a last lane parked: its row is all its own scratch page (the ids
    past the data pages, one per lane, as the engine lays them out)."""
    nb = s // ps
    n_data = b * nb
    pool_k, pool_v = (_randn(g, dev, dtype, n_data + b, ps, kv_heads, 128) for _ in range(2))
    table = torch.randperm(n_data, generator=g, device=dev)[: b * nb].reshape(b, nb).int()
    table[1, 0] = table[0, 0]
    table[b - 1] = n_data + b - 1
    return pool_k, pool_v, table


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page_size", [16, 64, 12])
@pytest.mark.parametrize("heads,kv_heads", [(4, 2), (8, 1), (32, 8)])
def test_paged_decode_kernel_matches_plain(dev, dtype, page_size, heads, kv_heads):
    g = torch.Generator(device=dev).manual_seed(3)
    b, s = 4, 256
    pool_k, pool_v, table = _paged_case(g, dev, dtype, b, heads, kv_heads, page_size, s)
    q = _randn(g, dev, dtype, b, heads, 128)
    pos = torch.tensor([0, 37, 200, s - 1], device=dev, dtype=torch.int32)
    before = ca.fused_paged_flash_decode.launches
    got = ca.fused_paged_flash_decode(q, pool_k, pool_v, table, pos)
    assert ca.fused_paged_flash_decode.launches == before + 1
    want = ca.paged_flash_decode_plain(q, pool_k, pool_v, table, pos)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page_size", [16, 64, 12])
@pytest.mark.parametrize("heads,kv_heads", [(4, 2), (8, 1), (32, 8)])
def test_paged_prefill_kernel_matches_plain(dev, dtype, page_size, heads, kv_heads):
    """Ragged offsets; lane 1's rows run past the arena end (bucket padding),
    where slots j >= S are masked."""
    g = torch.Generator(device=dev).manual_seed(4)
    b, t, s = 3, 70, 256
    pool_k, pool_v, table = _paged_case(g, dev, dtype, b, heads, kv_heads, page_size, s)
    q = _randn(g, dev, dtype, b, t, heads, 128)
    pos = (torch.tensor([5, 220, 100], device=dev)[:, None] + torch.arange(t, device=dev)).int()
    before = ca.fused_paged_flash_prefill.launches
    got = ca.fused_paged_flash_prefill(q, pool_k, pool_v, table, pos)
    assert ca.fused_paged_flash_prefill.launches == before + 1
    want = ca.paged_flash_prefill_plain(q, pool_k, pool_v, table, pos)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernels_equal_dense_kernels_on_the_same_kv(dev, dtype):
    """The paged kernels share the dense kernels' body: on the same K/V laid
    out both ways (pages through a scrambled table, and the gathered dense
    arena) the outputs are bit-identical."""
    from agentainer_tpu_torch.ops.attention import gather_pages

    g = torch.Generator(device=dev).manual_seed(5)
    b, s, heads, kv_heads = 4, 2048, 32, 8  # 8 decode splits
    pool_k, pool_v, table = _paged_case(g, dev, dtype, b, heads, kv_heads, 64, s)
    k, v = gather_pages(pool_k, pool_v, table)
    q = _randn(g, dev, dtype, b, heads, 128)
    pos = torch.tensor([3, 300, 1024, s - 1], device=dev, dtype=torch.int32)
    assert torch.equal(
        ca.fused_paged_flash_decode(q, pool_k, pool_v, table, pos), ca.flash_decode(q, k, v, pos)
    )
    q = _randn(g, dev, dtype, b, 96, heads, 128)
    pos = (torch.tensor([0, 100, 1900, 600], device=dev)[:, None] + torch.arange(96, device=dev)).int()
    assert torch.equal(
        ca.fused_paged_flash_prefill(q, pool_k, pool_v, table, pos), ca.flash_prefill(q, k, v, pos)
    )


GROUPS = [(8, 8), (16, 8), (32, 8), (16, 2), (32, 2)]  # G = 1, 2, 4, 8, 16


def _split_boundaries(s):
    """Every split's first and last slot, plus -1, 0 and past the arena."""
    split = ca.DECODE_SPLIT
    edges = [e for i in range(1, s // split) for e in (i * split - 1, i * split)]
    return torch.tensor([-1, 0, *edges, s - 1, s + 5], dtype=torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,kv_heads", GROUPS)
def test_decode_kernel_on_every_split_boundary(dev, dtype, heads, kv_heads):
    g = torch.Generator(device=dev).manual_seed(6)
    s = 2048
    pos = _split_boundaries(s).to(dev)
    b = pos.numel()
    q = _randn(g, dev, dtype, b, heads, 128)
    k, v = (_randn(g, dev, dtype, b, s, kv_heads, 128) for _ in range(2))
    got = ca.flash_decode(q, k, v, pos)
    want = ca.flash_decode_plain(q, k, v, pos)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])
    assert torch.count_nonzero(got[0]) == 0  # pos -1 sees no slot


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_on_the_served_mix(dev, dtype):
    """The served decode step: 2 live lanes near 300, 6 parked at S - 1."""
    g = torch.Generator(device=dev).manual_seed(7)
    b, s = 8, 2048
    q = _randn(g, dev, dtype, b, 32, 128)
    k, v = (_randn(g, dev, dtype, b, s, 8, 128) for _ in range(2))
    pos = torch.tensor([299, 312] + [s - 1] * 6, device=dev, dtype=torch.int32)
    got = ca.flash_decode(q, k, v, pos)
    torch.testing.assert_close(
        got.float(), ca.flash_decode_plain(q, k, v, pos).float(), rtol=TOL[dtype], atol=TOL[dtype]
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,kv_heads", GROUPS)
@pytest.mark.parametrize("t,offset", [(256, 300), (70, 1990)])
def test_prefill_kernel_on_served_and_ragged_chunks(dev, dtype, heads, kv_heads, t, offset):
    """The served 256-token chunk at offset 300, and a T that is not a
    multiple of any block's 64 / G tokens whose rows run past the arena."""
    g = torch.Generator(device=dev).manual_seed(8)
    s = 2048
    q = _randn(g, dev, dtype, 1, t, heads, 128)
    k, v = (_randn(g, dev, dtype, 1, s, kv_heads, 128) for _ in range(2))
    pos = (offset + torch.arange(t, device=dev, dtype=torch.int32))[None]
    got = ca.flash_prefill(q, k, v, pos)
    torch.testing.assert_close(
        got.float(), ca.flash_prefill_plain(q, k, v, pos).float(), rtol=TOL[dtype], atol=TOL[dtype]
    )


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_are_deterministic(dev, dtype):
    """No atomics and fixed merge orders: two launches on the same inputs
    give the same bits."""
    g = torch.Generator(device=dev).manual_seed(9)
    s = 2048
    q = _randn(g, dev, dtype, 8, 32, 128)
    k, v = (_randn(g, dev, dtype, 8, s, 8, 128) for _ in range(2))
    pos = torch.tensor([0, 17, 130, 511, 777, 1024, 1500, s - 1], device=dev, dtype=torch.int32)
    assert torch.equal(ca.flash_decode(q, k, v, pos), ca.flash_decode(q, k, v, pos))
    q = _randn(g, dev, dtype, 1, 256, 32, 128)
    pos = (300 + torch.arange(256, device=dev, dtype=torch.int32))[None]
    assert torch.equal(ca.flash_prefill(q, k[:1], v[:1], pos), ca.flash_prefill(q, k[:1], v[:1], pos))


def test_dispatch_on_the_card_raises_for_a_head_the_kernels_do_not_take(dev):
    """head_dim 64 on the card is refused by the kernels' wrappers; the
    dispatch does not run plain attention there."""
    from agentainer_tpu_torch.ops.attention import cache_attention, paged_cache_attention

    q = torch.zeros(1, 4, 4, 64, device=dev)
    kv = torch.zeros(1, 16, 2, 64, device=dev)
    pos = torch.arange(4, device=dev, dtype=torch.int32)[None]
    table = torch.zeros(1, 1, device=dev, dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported shape"):
        cache_attention(q, kv, kv, pos)
    with pytest.raises(ValueError, match="unsupported shape"):
        paged_cache_attention(q, kv, kv, table, pos)


# -- verify rounds: the prefill kernels at B = 8, T = K + 1 ------------------

VERIFY_T = [3, 5, 9]  # K + 1 for the verify buckets K = 2, 4, 8


def _verify_positions(dev, t, s):
    """The served verify mix: live lanes whose rows cross a 64-slot tile
    (and, paged, a page) boundary — 62.., 299.., 312.., 1021.. — and four
    parked lanes, every row at S - 1."""
    live = torch.tensor([62, 299, 312, 1021], device=dev)[:, None] + torch.arange(t, device=dev)
    parked = torch.full((4, t), s - 1, device=dev)
    return torch.cat([live, parked]).int()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,kv_heads", GROUPS)
@pytest.mark.parametrize("t", VERIFY_T)
def test_prefill_kernel_at_verify_shapes(dev, dtype, heads, kv_heads, t):
    g = torch.Generator(device=dev).manual_seed(10)
    b, s = 8, 2048
    q = _randn(g, dev, dtype, b, t, heads, 128)
    k, v = (_randn(g, dev, dtype, b, s, kv_heads, 128) for _ in range(2))
    pos = _verify_positions(dev, t, s)
    got = ca.flash_prefill(q, k, v, pos)
    torch.testing.assert_close(
        got.float(), ca.flash_prefill_plain(q, k, v, pos).float(), rtol=TOL[dtype], atol=TOL[dtype]
    )


def _verify_paged_case(g, dev, dtype, heads, kv_heads, ps, t):
    """Pools and a scrambled table for 8 lanes over S = the page multiple
    nearest below 2048; the parked lanes' rows are all their scratch page."""
    b = 8
    s = (2048 // ps) * ps
    nb = s // ps
    pool_k, pool_v = (_randn(g, dev, dtype, b * nb + b, ps, kv_heads, 128) for _ in range(2))
    table = torch.randperm(b * nb, generator=g, device=dev).reshape(b, nb).int()
    table[4:] = (b * nb + torch.arange(4, b, device=dev, dtype=torch.int32))[:, None]
    return pool_k, pool_v, table, _verify_positions(dev, t, s)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("page_size", [12, 16, 64])
@pytest.mark.parametrize("heads,kv_heads", GROUPS)
@pytest.mark.parametrize("t", VERIFY_T)
def test_paged_prefill_kernel_at_verify_shapes(dev, dtype, page_size, heads, kv_heads, t):
    g = torch.Generator(device=dev).manual_seed(11)
    pool_k, pool_v, table, pos = _verify_paged_case(g, dev, dtype, heads, kv_heads, page_size, t)
    q = _randn(g, dev, dtype, 8, t, heads, 128)
    got = ca.fused_paged_flash_prefill(q, pool_k, pool_v, table, pos)
    want = ca.paged_flash_prefill_plain(q, pool_k, pool_v, table, pos)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", VERIFY_T)
def test_paged_prefill_equals_dense_at_verify_shapes(dev, dtype, t):
    """Bit for bit on the same K/V (page size 64, S = 2048)."""
    from agentainer_tpu_torch.ops.attention import gather_pages

    g = torch.Generator(device=dev).manual_seed(12)
    pool_k, pool_v, table, pos = _verify_paged_case(g, dev, dtype, 32, 8, 64, t)
    k, v = gather_pages(pool_k, pool_v, table)
    q = _randn(g, dev, dtype, 8, t, 32, 128)
    assert torch.equal(
        ca.fused_paged_flash_prefill(q, pool_k, pool_v, table, pos), ca.flash_prefill(q, k, v, pos)
    )


# -- the int8-weight GEMM ------------------------------------------------------

# (K, N) of llama3-8b's and bench-1b's weights, and a narrow N that is not a
# multiple of the 128-column tile
W8_SHAPES = [
    (4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096), (4096, 128256),
    (2048, 5632), (5632, 2048), (2048, 32000), (256, 48),
]
# decode, ragged rows, the verify buckets, prefill chunks, two token tiles
W8_MS = [1, 8, 9, 13, 16, 24, 32, 40, 64, 72, 100, 255, 256, 300]
# one bf16 rounding of the output, plus the f32 sum-order error (far below
# 1e-4 at these widths): within the repo's bf16 3e-2
W8_RTOL, W8_ATOL = 2.0**-7, 1e-4


def _w8_case(g, dev, m, k, n):
    from agentainer_tpu_torch.ops.quant import quantize_array

    x = _randn(g, dev, torch.bfloat16, m, k)
    w = _randn(g, dev, torch.float32, k, n) * 0.02
    qt = quantize_array(w, torch.bfloat16)
    return x, qt.q, qt.scale


@pytest.mark.parametrize("k,n", W8_SHAPES)
def test_w8a16_kernel_matches_plain(dev, k, n):
    from agentainer_tpu_torch.ops import cuda_quant

    g = torch.Generator(device=dev).manual_seed(k + n)
    for m in W8_MS:
        x, q, scale = _w8_case(g, dev, m, k, n)
        before = cuda_quant.w8a16_matmul.launches
        got = cuda_quant.w8a16_matmul(x, q, scale)
        assert cuda_quant.w8a16_matmul.launches == before + 1
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (m, n)
        want = cuda_quant.w8a16_matmul_plain(x, q, scale)
        torch.testing.assert_close(
            got.float(), want.float(), rtol=W8_RTOL, atol=W8_ATOL,
            msg=lambda msg, m=m: f"M={m} K={k} N={n} {cuda_quant.plan(m, n, k)}: {msg}",
        )


def test_w8a16_split_is_deterministic_and_matches_one_split(dev):
    """The cluster-split path (wk: 8 splits at decode, 6 at a prefill chunk,
    summed in rank order through distributed shared memory) gives the same
    bits run to run, and the one-split kernel's result within one bf16
    rounding."""
    from agentainer_tpu_torch.ops import cuda_quant

    g = torch.Generator(device=dev).manual_seed(3)
    for m in (8, 256):
        x, q, scale = _w8_case(g, dev, m, 4096, 1024)
        bm, splits = cuda_quant.plan(m, 1024, 4096)
        assert splits == (8 if m == 8 else 6)
        a, b = cuda_quant.w8a16_matmul(x, q, scale), cuda_quant.w8a16_matmul(x, q, scale)
        assert torch.equal(a, b)
        one = torch.empty_like(a)
        err = cuda_quant._lib().atpu_w8a16_matmul(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), one.data_ptr(), m, 1024, 4096, bm, 1,
            torch.cuda.current_stream().cuda_stream,
        )
        assert err == 0
        torch.testing.assert_close(a.float(), one.float(), rtol=W8_RTOL, atol=W8_ATOL)


@pytest.mark.parametrize("m", [8, 72, 256])
def test_w8a16_graph_replay_equals_eager(dev, m):
    """A CUDA graph of the kernel (its tensor maps captured by value) gives
    the eager call's bits at every replay, split or not."""
    from agentainer_tpu_torch.ops import cuda_quant

    g = torch.Generator(device=dev).manual_seed(5)
    cases = [_w8_case(g, dev, m, k, n) for k, n in ((4096, 1024), (4096, 14336))]
    eager = [cuda_quant.w8a16_matmul(x, q, scale) for x, q, scale in cases]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    before = cuda_quant.w8a16_matmul.captured
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
        outs = [cuda_quant.w8a16_matmul(x, q, scale) for x, q, scale in cases]
    assert cuda_quant.w8a16_matmul.captured == before + len(cases)
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(outs, eager):
            assert torch.equal(got, want)


def test_w8a16_cluster_constants_are_the_cards(dev):
    """The plan's CLUSTERS_PER_WAVE are what an H100 runs at once for every
    token tile, so a planned split fits one wave."""
    from agentainer_tpu_torch.ops import cuda_quant

    if "H100" not in torch.cuda.get_device_name(dev):
        pytest.skip("the constants describe an H100")
    lib = cuda_quant._lib()
    for bm in cuda_quant.BLOCK_MS:
        got = {s: lib.atpu_w8a16_max_clusters(bm, s) for s in cuda_quant.CLUSTERS_PER_WAVE}
        assert got == cuda_quant.CLUSTERS_PER_WAVE, (bm, got)


def test_w8a16_library_refuses_what_the_kernel_does_not_take(dev):
    """The C entry point answers cudaErrorInvalidValue (1) for a token tile
    it has no body for, a split count outside 1..min(8, K / 64), or a shape
    off the tiles, and launches nothing."""
    from agentainer_tpu_torch.ops import cuda_quant

    g = torch.Generator(device=dev).manual_seed(6)
    x, q, scale = _w8_case(g, dev, 8, 256, 64)
    out = torch.full((8, 64), 7.0, dtype=torch.bfloat16, device=dev)
    lib = cuda_quant._lib()
    stream = torch.cuda.current_stream().cuda_stream
    for m, n, k, bm, splits in (
        (8, 64, 256, 16, 1), (8, 64, 256, 8, 0), (8, 64, 256, 8, 5), (8, 64, 256, 8, 9),
        (8, 64, 200, 8, 1), (8, 40, 256, 8, 1),
    ):
        assert lib.atpu_w8a16_matmul(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), m, n, k, bm, splits, stream
        ) == 1, (m, n, k, bm, splits)
    torch.cuda.synchronize()
    assert bool((out.float() == 7.0).all())


def test_w8a16_raises_for_what_the_kernel_does_not_take(dev):
    from agentainer_tpu_torch.ops import cuda_quant

    g = torch.Generator(device=dev).manual_seed(4)
    x, q, scale = _w8_case(g, dev, 8, 128, 64)
    with pytest.raises(ValueError, match="unsupported"):
        cuda_quant.w8a16_matmul(x[:, :96].contiguous(), q[:96].contiguous(), scale)
    with pytest.raises(ValueError, match="bf16 x"):
        cuda_quant.w8a16_matmul(x.float(), q, scale)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_quant.w8a16_matmul(x, q.t().contiguous().t(), scale)


def test_int8_decode_graph_counts_every_weight_product(dev):
    """An int8 engine's captured decode graph: each replay adds 7 kernel
    calls per layer plus 1 for lm_head per forward to ``launches``, as the
    eager step makes them, and the replay equals the eager step bit for
    bit."""
    from agentainer_tpu_torch.engine.graphs import compare_replay, live_lanes, park_lanes
    from agentainer_tpu_torch.ops import cuda_quant

    eng = _graph_engine(quant=True)
    w8 = cuda_quant.w8a16_matmul
    try:
        for kind, n in (("decode", 8), ("verify", 4)):
            key = (kind, n, True)
            forwards = n if kind == "decode" else 1
            live_lanes(eng, LIVE, 0.0, seed=n)
            try:
                with torch.no_grad(), eng._on_stream():
                    state = eng._device_state()
                    saved = [t.clone() for t in state]
                    before = w8.launches
                    eng._step_fn(key)()
                    eager = w8.launches - before
                    for t, s in zip(state, saved):
                        t.copy_(s)
                    before = w8.launches
                    eng._graphs.replay(key)
                    eng._graphs.replay(key)
                    torch.cuda.synchronize()
                    replayed = w8.launches - before
                    for t, s in zip(state, saved):
                        t.copy_(s)
                    got = compare_replay(eng._graphs, key, eng._step_fn(key), state, eng._gen)
            finally:
                park_lanes(eng)
            assert eager == (7 * 2 + 1) * forwards and replayed == 2 * eager, (kind, eager, replayed)
            assert got["tokens_equal"] and got["state_equal"] and got["replay_repeats"], got
    finally:
        eng.shutdown()


# -- the grouped int8 expert GEMM -----------------------------------------------

# (K, N, x): Mixtral-8x7B's expert stacks (gate/up from the shared x, down
# from each expert's input), and narrow ones off the 128-column tile
GROUPED_SHAPES = [
    (4096, 14336, "shared"), (14336, 4096, "per_expert"), (256, 48, "shared"), (128, 80, "per_expert"),
]
GROUPED_MS = [1, 8, 9, 24, 32, 40, 64, 72, 128, 255, 256, 300]


def _grouped_case(g, dev, e, m, k, n, per_expert):
    """Random int8 experts and per-channel scales (around a 0.02-std
    weight's), and bf16 x: ``[E, M, K]`` per expert or ``[M, K]`` shared."""
    q = torch.randint(-127, 128, (e, k, n), generator=g, device=dev, dtype=torch.int8)
    scale = ((torch.rand((e, 1, n), generator=g, device=dev) + 0.5) * (0.02 / 127)).to(torch.bfloat16)
    x = _randn(g, dev, torch.bfloat16, *((e, m, k) if per_expert else (m, k)))
    return x, q, scale


@pytest.mark.parametrize("e", [1, 4, 8])
@pytest.mark.parametrize("k,n,mode", GROUPED_SHAPES)
def test_w8a16_grouped_kernel_matches_plain(dev, e, k, n, mode):
    """Every expert's product in one launch, within one bf16 rounding of
    the plain version, at ragged token counts on both sides of the tiles;
    with E = 1 it equals ``w8a16_matmul`` of the one weight bit for bit
    (same body, same plan)."""
    from agentainer_tpu_torch.ops import cuda_quant

    g = torch.Generator(device=dev).manual_seed(e * 1000 + k + n)
    for m in GROUPED_MS:
        x, q, scale = _grouped_case(g, dev, e, m, k, n, mode == "per_expert")
        before = cuda_quant.w8a16_grouped_matmul.launches
        got = cuda_quant.w8a16_grouped_matmul(x, q, scale)
        assert cuda_quant.w8a16_grouped_matmul.launches == before + 1
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (e, m, n)
        want = cuda_quant.w8a16_matmul_plain(x, q, scale)
        torch.testing.assert_close(
            got.float(), want.float(), rtol=W8_RTOL, atol=W8_ATOL,
            msg=lambda msg, m=m: f"E={e} M={m} K={k} N={n} {mode} {cuda_quant.plan(m, n, k, e)}: {msg}",
        )
        if e == 1:
            x1 = x[0] if x.dim() == 3 else x
            assert torch.equal(got[0], cuda_quant.w8a16_matmul(x1, q[0], scale[0]))


@pytest.mark.parametrize("m", [8, 256])
def test_w8a16_grouped_is_deterministic_and_replays_in_a_graph(dev, m):
    """Two calls give the same bits, and a CUDA graph of the call gives the
    eager bits at every replay, counting its calls in ``.captured``."""
    from agentainer_tpu_torch.ops import cuda_quant

    g = torch.Generator(device=dev).manual_seed(m)
    cases = [
        _grouped_case(g, dev, 8, m, 4096, 14336, False), _grouped_case(g, dev, 8, m, 14336, 4096, True),
    ]
    eager = [cuda_quant.w8a16_grouped_matmul(*c) for c in cases]
    assert all(torch.equal(a, cuda_quant.w8a16_grouped_matmul(*c)) for a, c in zip(eager, cases))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    before = cuda_quant.w8a16_grouped_matmul.captured
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
        outs = [cuda_quant.w8a16_grouped_matmul(*c) for c in cases]
    assert cuda_quant.w8a16_grouped_matmul.captured == before + len(cases)
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(got, want) for got, want in zip(outs, eager))


def test_router_route_refuses_nothing_and_qmatmul_still_raises(dev):
    """Mixtral's int8 router [4096, 8] (8-byte rows, below TMA's 16) goes
    its own route, ``x @ dequant(router)`` in x's dtype, and equals the
    plain product on the CPU within one bf16 rounding; ``qmatmul`` of the
    same leaf raises instead of falling back, and so does the grouped
    wrapper on a stack the kernel does not take."""
    from agentainer_tpu_torch.models.llama import _router_logits
    from agentainer_tpu_torch.ops import cuda_quant
    from agentainer_tpu_torch.ops.quant import QTensor, qmatmul, qmatmul_experts, quantize_array

    g = torch.Generator(device=dev).manual_seed(11)
    router = quantize_array(_randn(g, dev, torch.float32, 4096, 8) * 0.02, torch.bfloat16)
    x = _randn(g, dev, torch.bfloat16, 24, 4096)
    got = _router_logits(x, router)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (24, 8)
    cpu = QTensor(router.q.cpu(), router.scale.cpu())
    want = _router_logits(x.cpu().float(), QTensor(cpu.q, cpu.scale.float()))
    torch.testing.assert_close(got.cpu().float(), want, rtol=3e-2, atol=3e-2)
    with pytest.raises(ValueError, match="unsupported"):
        qmatmul(x, router)
    stack = QTensor(router.q[None].expand(4, -1, -1).contiguous(), router.scale[None].expand(4, -1, -1).contiguous())
    with pytest.raises(ValueError, match="unsupported"):
        qmatmul_experts(x, stack)
    x3 = _randn(g, dev, torch.bfloat16, 2, 8, 4096)
    q, scale = _grouped_case(g, dev, 4, 8, 4096, 64, False)[1:]
    with pytest.raises(ValueError, match="do not chain"):
        cuda_quant.w8a16_grouped_matmul(x3, q, scale)  # 2 inputs for 4 experts


# an unregistered MoE config with a kernel-shaped head (head_dim 128)
MOE_HD128 = dict(
    name="test-moe-hd128", vocab_size=320, dim=256, n_layers=2, n_heads=2, n_kv_heads=1,
    ffn_dim=512, max_seq_len=512, rope_theta=10_000.0, n_experts=4, experts_per_token=2,
)


@pytest.mark.parametrize("routed", [False, True], ids=["dense_moe", "routed"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_int8_moe_engine_serves_on_the_card(dev, paged, routed):
    """A head_dim-128 MoE config in int8 served on both arenas, dense-einsum
    and routed: every request answers, every expert product runs the
    grouped kernel (3 per layer per forward, through the graph replays)
    and every other weight product ``w8a16_matmul``, and a decode graph
    replays its eager step bit for bit."""
    import asyncio

    from agentainer_tpu_torch.engine.graphs import compare_replay, live_lanes, park_lanes
    from agentainer_tpu_torch.engine.llm import LLMEngine
    from agentainer_tpu_torch.engine.quant import quantize_params
    from agentainer_tpu_torch.engine.tokenizer import ByteTokenizer
    from agentainer_tpu_torch.models.configs import ModelConfig
    from agentainer_tpu_torch.models.llama import init_params
    from agentainer_tpu_torch.ops import cuda_quant

    cfg = ModelConfig(**MOE_HD128)
    params = quantize_params(
        init_params(cfg, torch.Generator(device=dev).manual_seed(0), torch.bfloat16, dev), torch.bfloat16
    )
    eng = LLMEngine(
        cfg, params, ByteTokenizer(cfg.vocab_size), max_batch=4, max_seq=512, page_size=64,
        paged_kv=paged, routed_moe=routed, moe_capacity_factor=4.0, device="cuda",
    )
    grouped, w8 = cuda_quant.w8a16_grouped_matmul, cuda_quant.w8a16_matmul
    try:
        eng.warmup()
        assert eng.metrics()["moe_routed"] is routed

        async def traffic():
            return await asyncio.gather(
                eng.generate("mixture of experts " * 12, max_tokens=20, ignore_eos=True),
                eng.generate("a second request", max_tokens=12, ignore_eos=True),
            )

        before_g, before_w = grouped.launches, w8.launches
        outs = asyncio.run(traffic())
        assert [o["completion_tokens"] for o in outs] == [20, 12]
        used_g, used_w = grouped.launches - before_g, w8.launches - before_w
        assert used_g > 0 and used_g % (3 * cfg.n_layers) == 0, used_g
        assert used_w == (used_g // (3 * cfg.n_layers)) * (4 * cfg.n_layers + 1), (used_g, used_w)
        key = ("decode", 8, True)
        live_lanes(eng, [40, 300], 0.0, seed=1)
        try:
            with torch.no_grad(), eng._on_stream():
                got = compare_replay(eng._graphs, key, eng._step_fn(key), eng._device_state(), eng._gen)
        finally:
            park_lanes(eng)
        assert got["tokens_equal"] and got["state_equal"] and got["replay_repeats"], got
        assert eng.worker_errors == 0, eng.last_worker_error
    finally:
        eng.shutdown()


# -- the engine's step graphs: 2 layers at llama3-8b width, bf16 -------------


def _graph_engine(quant: bool = False, **options):
    """A warmed card engine of llama3-8b's width at 2 layers (random bf16
    weights from seed 0, quantized to int8 with ``quant``); warmup captures
    its step graphs."""
    import dataclasses

    from agentainer_tpu_torch.engine.llm import LLMEngine
    from agentainer_tpu_torch.engine.quant import quantize_params
    from agentainer_tpu_torch.engine.tokenizer import ByteTokenizer
    from agentainer_tpu_torch.models.configs import get_config
    from agentainer_tpu_torch.models.llama import init_params

    cfg = dataclasses.replace(get_config("llama3-8b"), name="llama3-8b-2l", n_layers=2)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, g, dtype=torch.bfloat16, device="cuda")
    if quant:
        params = quantize_params(params, torch.bfloat16)
    opts = dict(max_batch=8, max_seq=1024, page_size=64, device="cuda")
    opts.update(options)
    eng = LLMEngine(cfg, params, ByteTokenizer(cfg.vocab_size), **opts)
    eng.warmup()
    return eng


@pytest.fixture(scope="module", params=["dense", "paged"])
def graph_engine(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    eng = _graph_engine(paged_kv=request.param == "paged")
    yield eng
    eng.shutdown()


GRAPH_KEYS = (
    [("decode", c) for c in (1, 2, 4, 8)] + [("verify", k) for k in (2, 4, 8)]
    + [("prefill", b) for b in (32, 64, 128, 256)]
)
LIVE = [40, 300, 777, 1000]  # lanes 0-3 live (a 64-slot tile and a page crossed), 4-7 parked


@pytest.mark.parametrize("kind,n", GRAPH_KEYS)
def test_graph_replay_equals_eager_bit_for_bit(graph_engine, kind, n):
    """From one saved state, the greedy step's replay gives the eager step's
    tokens, carry, verify inputs, block table and KV bytes, bit for bit."""
    from agentainer_tpu_torch.engine.graphs import compare_replay, live_lanes, park_lanes

    eng = graph_engine
    key = (kind, n, True)
    live_lanes(eng, LIVE, 0.0, seed=n)
    try:
        with torch.no_grad(), eng._on_stream():
            got = compare_replay(eng._graphs, key, eng._step_fn(key), eng._device_state(), eng._gen)
    finally:
        park_lanes(eng)
    assert got["tokens_equal"] and got["state_equal"] and got["replay_repeats"], got


@pytest.mark.parametrize("kind,n", [("decode", 8), ("verify", 4), ("prefill", 128)])
def test_graph_replays_count_the_eager_calls_launches(graph_engine, kind, n):
    """N replays add N times the kernel calls of one eager step to the
    wrappers' ``launches``; capture added none."""
    from agentainer_tpu_torch.engine.graphs import KERNEL_WRAPPERS, live_lanes, park_lanes

    eng = graph_engine
    key = (kind, n, True)
    live_lanes(eng, LIVE, 0.0, seed=0)
    state = eng._device_state()
    try:
        with torch.no_grad(), eng._on_stream():
            saved = [t.clone() for t in state]
            before = [w.launches for w in KERNEL_WRAPPERS]
            eng._step_fn(key)()
            eager = [w.launches - b for w, b in zip(KERNEL_WRAPPERS, before)]
            for t, s in zip(state, saved):
                t.copy_(s)
            before = [w.launches for w in KERNEL_WRAPPERS]
            for _ in range(3):
                eng._graphs.replay(key)
            torch.cuda.synchronize()
            replayed = [w.launches - b for w, b in zip(KERNEL_WRAPPERS, before)]
            for t, s in zip(state, saved):
                t.copy_(s)
    finally:
        park_lanes(eng)
    assert sum(eager) == 2 * (n if kind == "decode" else 1)  # one attention call per layer
    if kind == "prefill":
        assert eng._graphs.replays_by_kind["prefill"] >= 3
    assert replayed == [3 * e for e in eager]


def test_runtime_contracts_hold_on_the_card(graph_engine):
    """The card half of ``analysis/contracts.py`` on a warmed 2-layer
    engine: served traffic (prefill, decode rungs, verify rounds, a sampled
    lane) under ``capture_budget(engine, 0)`` (no new key, no capture,
    every dispatch a replay), ``buffers_in_place`` and
    ``no_implicit_sync``; then one replay of every captured step traced:
    the arena's attention wrapper launches 2 layers x its device launches
    per call x the step's forwards, and no other kernel of the table."""
    import asyncio

    from agentainer_tpu_torch.analysis.contracts import (
        AttentionLaunches,
        buffers_in_place,
        capture_budget,
        check,
        launches_per_replay,
    )
    from agentainer_tpu_torch.engine.graphs import park_lanes

    eng = graph_engine

    async def traffic():
        return await asyncio.gather(
            eng.generate("a" * 200, max_tokens=40),
            eng.generate("a plain request", max_tokens=21, ignore_eos=True),
            eng.generate("sampled " * 3, max_tokens=13, temperature=1.0, ignore_eos=True),
        )

    with capture_budget(eng, 0) as seen, buffers_in_place(eng) as kinds, no_implicit_sync():
        out = asyncio.run(traffic())
    assert eng.worker_errors == 0, eng.last_worker_error
    assert [r["completion_tokens"] for r in out[1:]] == [21, 13]
    assert {"prefill", "decode", "verify"} <= set(kinds), (seen, kinds)
    park_lanes(eng)
    want = AttentionLaunches(n_layers=eng.cfg.n_layers, paged=eng.paged)
    for key in eng._step_keys():
        for _ in range(3):  # a trace that lost device records is taken again
            with torch.no_grad(), eng._on_stream():
                got = launches_per_replay(eng._graphs, key)
            if not want.failures(got):
                break
        check(got, want)
        assert got["all"] > got["wrappers"]["flash_prefill"]["device"], got


@pytest.mark.parametrize("kind,n", [("decode", 4), ("verify", 8)])
def test_sampled_graph_replays_a_seeded_stream(graph_engine, kind, n):
    """The sampled step's graph draws from the engine's generator: from the
    same generator state two replays repeat each other, and a replay after
    another draws fresh numbers."""
    from agentainer_tpu_torch.engine.graphs import compare_replay, live_lanes, park_lanes

    eng = graph_engine
    key = (kind, n, False)
    live_lanes(eng, LIVE, 1.0, seed=1)
    state = eng._device_state()
    try:
        with torch.no_grad(), eng._on_stream():
            got = compare_replay(eng._graphs, key, eng._step_fn(key), state, eng._gen)
            saved = [t.clone() for t in state]
            first = eng._graphs.replay(key).clone()
            for t, s in zip(state, saved):
                t.copy_(s)
            again = eng._graphs.replay(key).clone()
            for t, s in zip(state, saved):
                t.copy_(s)
            fresh = not torch.equal(first, again)  # on the stream that made them
    finally:
        park_lanes(eng)
    assert got["replay_repeats"], got
    assert fresh, (first, again)


def test_paged_pages_freed_under_an_in_flight_chunk_are_safe_to_reuse(dev):
    """A paged session is cancelled while a decode chunk that writes its
    pages is still in flight (each chunk waits behind a ~40 ms spin), its
    pages go straight back to the free list, and the next session takes
    them at once: its greedy tokens equal the same request's on a quiet
    engine. Stream order, not a quarantine, keeps the stale write ahead of
    the new owner's."""
    import asyncio

    eng = _graph_engine(
        paged_kv=True, max_batch=1, max_seq=512, kv_pages=12, prefix_cache=False,
        speculative=False,
    )
    try:
        decode_n, free_ids, alloc = eng._decode_n, eng._free_page_ids, eng._alloc_pages
        log = {"freed": [], "taken": []}

        def in_flight() -> bool:
            return any(not e.event.query() for e in eng._readbacks)

        def state():
            return [time.perf_counter(), [(e.kind, e.event.query()) for e in eng._readbacks]]

        def slow_decode(chunk):
            torch.cuda._sleep(80_000_000)
            return decode_n(chunk)

        def logged_free(ids):
            log["freed"].append((list(ids), in_flight(), state()))
            free_ids(ids)

        def logged_alloc(n, pin=False, **kw):
            ids = alloc(n, pin, **kw)
            log["taken"].append((list(ids), in_flight(), state()))
            return ids

        eng._decode_n, eng._free_page_ids, eng._alloc_pages = slow_decode, logged_free, logged_alloc
        prompt = "the new owner of the pages " * 3

        async def overlap():
            a = asyncio.ensure_future(eng.generate(
                "a long request " * 4, max_tokens=300, ignore_eos=True, request_id="A", session="a",
            ))
            while eng.decode_steps < 3:
                await asyncio.sleep(0.005)
            b = asyncio.ensure_future(eng.generate(prompt, max_tokens=24, ignore_eos=True, session="b"))
            await asyncio.sleep(0)
            eng.cancel("A")
            done = await asyncio.gather(a, b, return_exceptions=True)
            return done

        a, b = asyncio.run(overlap())
        eng._decode_n, eng._free_page_ids, eng._alloc_pages = decode_n, free_ids, alloc
        assert type(a).__name__ == "RequestCancelled", a
        stale = {p for ids, flying, _ in log["freed"] if flying for p in ids}
        assert stale, log
        assert any(flying and stale & set(ids) for ids, flying, _ in log["taken"]), log
        assert stale & set(eng.paged_sessions["b"].pages)
        eng.clear_sessions()
        quiet = asyncio.run(eng.generate(prompt, max_tokens=24, ignore_eos=True, session="b2"))
        assert b["tokens"] == quiet["tokens"]
        assert eng.worker_errors == 0, eng.last_worker_error
    finally:
        eng.shutdown()


@pytest.mark.parametrize("paged", [False, True])
def test_served_path_makes_no_implicit_host_sync(dev, paged):
    """Served traffic — prefill, graph-replayed decode chunks, verify rounds
    and their readbacks — under ``torch.cuda.set_sync_debug_mode("error")``:
    no operation of the worker waits for the device behind its back (the
    readbacks wait on their CUDA events, which the mode does not flag)."""
    _serve_without_host_sync(dev, _graph_engine(paged_kv=paged, max_seq=512))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_int8_served_path_makes_no_implicit_host_sync(dev, paged):
    """The same traffic on an int8 engine: every weight product is the
    int8 kernel, and none waits for the device."""
    from agentainer_tpu_torch.ops import cuda_quant

    eng = _graph_engine(quant=True, paged_kv=paged, max_seq=512)
    before = cuda_quant.w8a16_matmul.launches
    _serve_without_host_sync(dev, eng)
    assert cuda_quant.w8a16_matmul.launches > before


def _serve_without_host_sync(dev, eng) -> None:
    import asyncio

    streamed: list[int] = []
    try:
        async def traffic():
            return await asyncio.gather(
                eng.generate("a" * 200, max_tokens=40),  # one repeated byte: verify rounds
                eng.generate("a plain request", max_tokens=21, ignore_eos=True),
                eng.generate("sampled " * 3, max_tokens=13, temperature=1.0, ignore_eos=True),
                # a streamed request: its tokens reach emit from the readbacks
                eng.generate(
                    "a streamed request " * 20, max_tokens=17, ignore_eos=True,
                    emit=lambda start, ids: streamed.extend(ids),
                ),
            )

        with no_implicit_sync():
            with pytest.raises(RuntimeError, match="synchroniz"):
                torch.ones(1, device=dev).item()  # the mode is on
            out = asyncio.run(traffic())
        assert torch.cuda.get_sync_debug_mode() == 0  # restored
        assert eng.worker_errors == 0, eng.last_worker_error
        assert [r["completion_tokens"] for r in out[1:]] == [21, 13, 17]
        assert streamed == out[3]["tokens"]
        m = eng.metrics()
        assert m["graph_replays"] > 0 and m["spec_rounds"] > 0, m
        # every prefill chunk was one graph replay
        assert m["prefill_graph_replays"] == m["prefill_chunks"] > 0, m
    finally:
        eng.shutdown()


# -- the checkpoint plane on the card: 2 layers at llama3-8b width, bf16 -----


def _snapshot_engine(**options):
    """A warmed 2-layer card engine with speculation and the prefix cache
    off (greedy continuations then compare exactly), the staging limiter
    spaced to nothing."""
    eng = _graph_engine(speculative=False, prefix_cache=False, **options)
    eng.snapshot_min_gap_s = 0.0
    return eng


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_restore_after_capture_replays_the_restored_kv(dev, paged):
    """A snapshot restored into an engine whose step graphs are captured:
    the arena tensors keep their addresses, a decode replay over the
    restored session equals its eager step bit for bit, and the restored
    session continues exactly as the original does."""
    import asyncio

    from agentainer_tpu_torch.engine.graphs import compare_replay, park_lanes

    eng = _snapshot_engine(paged_kv=paged)
    try:
        state = eng._device_state()
        ptrs = [t.data_ptr() for t in state]

        async def first():
            await eng.chat("orig", "a conversation worth keeping " * 6, max_tokens=40, ignore_eos=True)
            blob = await eng.snapshot_session("orig")
            assert await eng.restore_session("copy", blob) is True
            return blob

        asyncio.run(first())
        assert [t.data_ptr() for t in eng._device_state()] == ptrs
        # lane 0 decodes the restored session, the others stay parked
        with torch.no_grad(), eng._on_stream():
            if paged:
                sess = eng.paged_sessions["copy"]
                assert sess.lane is None
                slot, pos = eng.slots[0], sess.position
                eng._bind_lane_bt(slot, sess)
                eng._sync_table()
            else:
                slot = eng.slots[eng.sessions["copy"]]
                pos = slot.position
            eng._inject_lane(slot.idx, 17, pos, 0.0, 0, 1.0)
            key = ("decode", 1, True)
            got = compare_replay(eng._graphs, key, eng._step_fn(key), eng._device_state(), eng._gen)
        park_lanes(eng)
        assert got["tokens_equal"] and got["state_equal"] and got["replay_repeats"], got

        async def second():
            a = await eng.chat("orig", "and then", max_tokens=24, ignore_eos=True)
            b = await eng.chat("copy", "and then", max_tokens=24, ignore_eos=True)
            return a["tokens"], b["tokens"]

        a, b = asyncio.run(second())
        assert a == b
        assert eng.worker_errors == 0, eng.last_worker_error
    finally:
        eng.shutdown()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_snapshot_under_load_stages_at_the_finish(dev, paged):
    """A snapshot asked for while a chunk of the same session is in flight
    parks, is staged at the request's finish, and carries the payload of a
    snapshot of the same turn taken on a quiet engine."""
    import asyncio

    from agentainer_tpu_torch.engine.checkpoint import deserialize_kv_slot

    eng = _snapshot_engine(paged_kv=paged)
    prompt = "a long request under load " * 4
    try:

        async def busy():
            gen = asyncio.ensure_future(eng.chat("L", prompt, max_tokens=300, ignore_eos=True))
            while not any(s.decoding and s.session == "L" for s in eng.slots):
                await asyncio.sleep(0.001)
            snap = asyncio.ensure_future(eng.snapshot_session("L"))
            while "L" not in eng._snap_parked:
                await asyncio.sleep(0.001)
            assert not gen.done()
            return await gen, await snap

        _, blob = asyncio.run(busy())

        async def quiet():
            await eng.chat("Q", prompt, max_tokens=300, ignore_eos=True)
            return await eng.snapshot_session("Q")

        (k, v, h), (qk, qv, qh) = deserialize_kv_slot(blob), deserialize_kv_slot(asyncio.run(quiet()))
        assert h["position"] == qh["position"] and h["pending_token"] == qh["pending_token"]
        assert torch.equal(k, qk) and torch.equal(v, qv)
    finally:
        eng.shutdown()


def _write_safetensors(path, tensors: dict) -> None:
    """A bf16 safetensors file written with the standard library: the 8-byte
    header length, the JSON header, then each tensor's bytes in order."""
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": "BF16", "shape": list(t.shape), "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little") + raw)
        for t in tensors.values():
            f.write(t.contiguous().cpu().view(torch.int16).numpy().tobytes())


def test_stdlib_reader_loads_a_full_width_checkpoint_onto_the_card(dev, tmp_path):
    """A 2-layer llama3-8b-width checkpoint in HF's layout, sharded over two
    files with an index, loads onto the card bit-equal to the tree it was
    written from."""
    import dataclasses

    from agentainer_tpu_torch.engine.hf_convert import load_hf_params
    from agentainer_tpu_torch.models.configs import get_config
    from agentainer_tpu_torch.models.llama import init_params

    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=2)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(3), device="cuda")
    lay = params["layers"]
    named = {"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["final_norm"]}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        named[p + "input_layernorm.weight"] = lay["attn_norm"][i]
        named[p + "post_attention_layernorm.weight"] = lay["mlp_norm"][i]
        for leaf, proj in (("wq", "self_attn.q_proj"), ("wk", "self_attn.k_proj"),
                           ("wv", "self_attn.v_proj"), ("wo", "self_attn.o_proj"),
                           ("w_gate", "mlp.gate_proj"), ("w_up", "mlp.up_proj"),
                           ("w_down", "mlp.down_proj")):
            named[p + proj + ".weight"] = lay[leaf][i].t()
    named["lm_head.weight"] = params["lm_head"].t()
    names = list(named)
    shards = {"model-00001-of-00002.safetensors": names[::2], "model-00002-of-00002.safetensors": names[1::2]}
    for shard, part in shards.items():
        _write_safetensors(tmp_path / shard, {n: named[n] for n in part})
    (tmp_path / "model.safetensors.index.json").write_text(
        json.dumps({"weight_map": {n: s for s, part in shards.items() for n in part}})
    )
    stats = {}
    got = load_hf_params(cfg, tmp_path, dtype=torch.bfloat16, device="cuda", stats=stats)
    assert stats["bytes_read"] == 2 * cfg.param_count()
    for key in ("embed", "final_norm", "lm_head"):
        assert got[key].device.type == "cuda" and torch.equal(got[key], params[key]), key
    for key, t in lay.items():
        assert torch.equal(got["layers"][key], t), key


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_snapshot_and_restore_make_no_implicit_host_sync(dev, paged):
    """Served traffic with a snapshot and a restore in flight under
    ``torch.cuda.set_sync_debug_mode("error")``: the worker never waits for
    the device; the snapshot's wait is on its CUDA event, in the thread
    that packs the blob."""
    import asyncio

    eng = _graph_engine(paged_kv=paged, max_seq=512)
    # the limiter lets a snapshot through while other requests decode
    eng.snapshot_min_gap_s = eng.snapshot_busy_gap_s = eng.snapshot_force_s = 0.0
    try:

        async def warm():
            await eng.chat("s", "the session to save " * 3, max_tokens=20, ignore_eos=True)
            return await eng.snapshot_session("s")

        blob = asyncio.run(warm())

        async def traffic():
            return await asyncio.gather(
                eng.generate("a" * 200, max_tokens=40),
                eng.generate("a plain request", max_tokens=21, ignore_eos=True),
                eng.snapshot_session("s"),
                eng.restore_session("r", blob),
            )

        with no_implicit_sync():
            out = asyncio.run(traffic())
        assert eng.worker_errors == 0, eng.last_worker_error
        assert out[1]["completion_tokens"] == 21
        assert out[2] is not None and out[3] is True
    finally:
        eng.shutdown()


def test_chips_place_the_engine_on_that_card(dev):
    """``options["chips"] = [1]`` runs the engine, its stream, graphs and
    pinned buffers on cuda:1, leaving cuda:0 untouched, and it decodes the
    tokens an engine on cuda:0 decodes from the same weights."""
    import asyncio
    import dataclasses

    if torch.cuda.device_count() < 2:
        pytest.skip("this machine has one GPU: placing an engine on another card needs two")
    from agentainer_tpu_torch.engine.llm import LLMEngine, _engine_device
    from agentainer_tpu_torch.engine.tokenizer import ByteTokenizer
    from agentainer_tpu_torch.models.configs import get_config
    from agentainer_tpu_torch.models.llama import init_params

    cfg = dataclasses.replace(get_config("llama3-8b"), name="llama3-8b-2l", n_layers=2)
    params0 = init_params(cfg, torch.Generator(device="cuda:0").manual_seed(0), device="cuda:0")
    out = {}
    for chip in (1, 0):
        device = _engine_device("cuda", cfg, [chip])
        assert device == torch.device("cuda", chip)
        params = {k: (v.to(device) if torch.is_tensor(v) else {n: t.to(device) for n, t in v.items()})
                  for k, v in params0.items()}
        before = torch.cuda.memory_allocated(0)
        eng = LLMEngine(cfg, params, ByteTokenizer(cfg.vocab_size), max_batch=4, max_seq=512,
                        device=device)
        try:
            eng.warmup()
            r = asyncio.run(eng.generate("placed on a card", max_tokens=16, ignore_eos=True))
            out[chip] = r["tokens"]
            assert eng.metrics()["graph_replays"] > 0
            assert eng.cache.k.device == device and eng._dtok.device == device
            if chip == 1:
                assert torch.cuda.memory_allocated(0) == before
        finally:
            eng.shutdown()
    assert out[0] == out[1]


# -- prefill graphs, streaming and approx_topk on the card -------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_kernel_through_a_row_map_equals_the_row_view(dev, dtype):
    """The dense prefill kernel reading its arena row from device memory
    (``rows``) gives the bits of the same call on the row's view, and holds
    its plain version."""
    g = torch.Generator(device=dev).manual_seed(11)
    q = _randn(g, dev, dtype, 1, 256, 32, 128)
    k, v = (_randn(g, dev, dtype, 8, 2048, 8, 128) for _ in range(2))
    pos = (300 + torch.arange(256, device=dev, dtype=torch.int32))[None]
    for row in (0, 5):
        rows = torch.tensor([row], device=dev, dtype=torch.int32)
        got = ca.flash_prefill(q, k, v, pos, rows)
        assert torch.equal(got, ca.flash_prefill(q, k[row : row + 1], v[row : row + 1], pos))
        torch.testing.assert_close(
            got.float(), ca.flash_prefill_plain(q, k, v, pos, rows).float(),
            rtol=TOL[dtype], atol=TOL[dtype],
        )


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_prefill_replays_equal_eager_on_two_lanes(dev, paged, quant):
    """Every prefill bucket's graph, replayed for lane 0 from position 40
    and for lane 1 from 300 (27 real tokens: a chunk shorter than every
    bucket), equals its eager step bit for bit: logits, prefill inputs and
    every KV byte."""
    from agentainer_tpu_torch.engine.graphs import compare_replay, live_lanes, park_lanes

    eng = _graph_engine(quant=quant, paged_kv=paged)
    try:
        assert eng._prefill_buckets == [32, 64, 128, 256]
        for lane in (0, 1):
            for b in eng._prefill_buckets:
                key = ("prefill", b, True)
                live_lanes(eng, LIVE, 0.0, seed=b, prefill_lane=lane)
                try:
                    with torch.no_grad(), eng._on_stream():
                        got = compare_replay(
                            eng._graphs, key, eng._step_fn(key), eng._device_state(), eng._gen
                        )
                finally:
                    park_lanes(eng)
                assert got["tokens_equal"] and got["state_equal"] and got["replay_repeats"], (lane, b, got)
    finally:
        eng.shutdown()


def test_a_streamed_request_makes_no_more_host_syncs_than_a_buffered_one(dev):
    """The same prompt buffered, then streamed (no prefix cache: both
    prefill the whole prompt the same way): the same tokens, and the same
    host syncs."""
    import asyncio

    eng = _graph_engine(max_seq=512, prefix_cache=False)
    try:
        def syncs(**kw):
            before = eng.metrics()["host_syncs_total"]
            res = asyncio.run(eng.generate("the same prompt " * 5, max_tokens=24, ignore_eos=True, **kw))
            return eng.metrics()["host_syncs_total"] - before, res["tokens"]

        buffered, want = syncs()
        seen: list[int] = []
        streamed, got = syncs(emit=lambda start, ids: seen.extend(ids))
    finally:
        eng.shutdown()
    assert streamed == buffered > 0 and got == want == seen


def test_approx_topk_draws_fall_in_the_plain_keep_set(dev):
    """``approx_topk`` on the card (``torch.topk`` over the segment) draws
    only tokens the plain filter keeps, for every lane's filter."""
    from agentainer_tpu_torch.engine import sampling

    g = torch.Generator(device=dev).manual_seed(3)
    logits = torch.randn((8, 128256), generator=g, device=dev) * 3
    top_k = torch.tensor([0, 1, 50, 200, 0, 0, 40, 500], device=dev)
    top_p = torch.tensor([1.0, 1.0, 1.0, 1.0, 0.9, 0.5, 0.8, 0.95], device=dev)
    temps = torch.ones(8, device=dev)
    keep = sampling.filter_logits(logits.cpu(), top_k.cpu(), top_p.cpu(), approx_topk=True) > sampling.NEG_INF
    for _ in range(20):
        draws = sampling.sample_step(logits, g, temps, top_k, top_p, all_greedy=False, approx_topk=True)
        assert bool(keep[torch.arange(8), draws.cpu()].all())
    assert int(keep[1:].sum(dim=-1).max()) <= sampling.APPROX_SEG  # lane 0 filters nothing


# -- the fused decode loop and the KV tiers on the card: 2 layers ----------

FUSED_CASES = [
    pytest.param({}, id="dense"),
    pytest.param({"paged_kv": True}, id="paged"),
    pytest.param({"quant": True}, id="int8"),
    pytest.param({"quant": True, "paged_kv": True}, id="int8-paged"),
]


@pytest.mark.parametrize("inloop", [True, False], ids=["inloop", "plain"])
@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_loop_graph_equals_eager_bit_for_bit(dev, case, inloop):
    """The captured loop (a WHILE node over the iteration's segment graphs,
    with the verify and plain branches as IF nodes when in-loop spec is on)
    against the eager loop over the same segment functions, from one
    saved state: greedy lanes give the same packed readback, carry,
    history, shadow carry and KV bytes, bit for bit, with the verify branch
    taken (in-loop) and one lane absorbed from the shadow carry; a sampled
    loop replayed twice from one generator state repeats itself. The
    int8 engines run ``w8a16_matmul`` inside the conditional bodies."""
    from agentainer_tpu_torch.engine.graphs import compare_replay, live_fused, live_lanes, park_lanes

    opts = dict(case)
    quant = opts.pop("quant", False)
    eng = _graph_engine(quant=quant, fused_decode=True, inloop_spec=inloop, **opts)
    try:
        assert eng.inloop_spec is inloop
        out = {}
        for temperature, greedy in ((0.0, True), (1.0, False)):
            key = ("fused", eng._fused_cap, greedy)
            live_lanes(eng, LIVE, temperature, seed=int(greedy))
            live_fused(eng, LIVE[:3], temperature, seed=int(greedy), nsteps=eng._fused_cap - 3,
                       budgets=[eng._fused_cap + 1, 9, eng._fused_cap + 1], armed_lane=3)
            try:
                with torch.no_grad(), eng._on_stream():
                    got = compare_replay(eng._graphs, key, eng._step_fn(key), eng._device_state(), eng._gen)
                    packed = eng._graphs.replay(key).clone().cpu()
            finally:
                park_lanes(eng)
            out[greedy] = (got, packed)
        got, packed = out[True]
        assert got["tokens_equal"] and got["state_equal"] and got["replay_repeats"], got
        cap_rows = eng._fused_cap + 1
        # lane 0 runs every iteration (with in-loop spec it may reach its
        # budget first)
        assert packed[cap_rows + 2, 0] == eng._fused_cap - 3 or inloop, packed[cap_rows:]
        assert packed[cap_rows, 1] == 9  # lane 1 froze at its budget
        if inloop:
            assert packed[cap_rows + 5, 0] > 0, packed[cap_rows:]  # verify iterations ran
        assert out[False][0]["replay_repeats"], out[False][0]
    finally:
        eng.shutdown()


def test_fused_loop_exits_early_on_the_device(dev):
    """A loop bound of the full cap whose one live lane freezes at its
    budget of 3 runs 3 iterations: in a profiler trace of the replay the
    dense decode kernel and its combine launch n_layers x 2 x 3 times, not
    x nsteps."""
    from torch.profiler import ProfilerActivity, profile

    from agentainer_tpu_torch.engine.graphs import live_fused, live_lanes, park_lanes

    eng = _graph_engine(fused_decode=True, speculative=False)
    try:
        key = ("fused", eng._fused_cap, True)
        # the profiler traces every iteration only of a loop graph
        # instantiated after it first came up (StepGraphs.rebuild_loop); a
        # trace that lost device records is taken again, up to 3 times, as
        # chip_smoke.py does
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
        eng._graphs.rebuild_loop(key)
        for _ in range(3):
            live_lanes(eng, LIVE[:2], 0.0, seed=0)
            live_fused(eng, LIVE[:1], 0.0, seed=0, nsteps=eng._fused_cap, budgets=[3])
            with torch.no_grad(), eng._on_stream():
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    packed = eng._graphs.replay(key).clone()
                    torch.cuda.synchronize()
            park_lanes(eng)
            steps = int(packed[eng._fused_cap + 3, 0])
            names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
            decode = sum("decode_kernel" in n and "combine" not in n for n in names)
            combine = sum("decode_combine_kernel" in n for n in names)
            if decode == combine == eng.cfg.n_layers * steps:
                break
        assert steps == 3, packed[eng._fused_cap + 1 :]
        assert decode == combine == eng.cfg.n_layers * steps, (decode, combine)
    finally:
        eng.shutdown()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_fused_engine_serves_the_unfused_greedy_text(dev, paged):
    """With speculation off a fused loop's iteration is the ladder's [8, 1]
    decode step: the served greedy tokens equal the unfused engine's, with
    one readback per loop and no implicit host sync."""
    import asyncio

    prompts = ["a plain request", "another, longer, request " * 4, "third"]

    async def traffic(eng):
        return await asyncio.gather(*(eng.generate(p, max_tokens=45, ignore_eos=True) for p in prompts))

    want_eng = _graph_engine(speculative=False, paged_kv=paged)
    try:
        want = [r["tokens"] for r in asyncio.run(traffic(want_eng))]
    finally:
        want_eng.shutdown()
    eng = _graph_engine(fused_decode=True, speculative=False, paged_kv=paged)
    try:
        with no_implicit_sync():
            got = [r["tokens"] for r in asyncio.run(traffic(eng))]
        m = eng.metrics()
        assert eng.worker_errors == 0, eng.last_worker_error
        assert got == want
        assert m["fused_loops_total"] > 0 and m["host_syncs_total"] == m["prefills"] + m["fused_loops_total"]
    finally:
        eng.shutdown()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_pinned_park_and_promote_round_trip_bit_exact(dev, paged):
    """tier_quantize 0: a parked session's KV leaves through pinned memory
    and comes back bit for bit (its pages or row hold the same bytes after
    the promotion), and its next turn continues as a never-parked one."""
    import asyncio

    from agentainer_tpu_torch.engine.checkpoint import deserialize_kv_slot

    def kv(eng, name):
        if paged:
            sess = eng.paged_sessions[name]
            ids = torch.tensor(sess.pages, device=dev)
            n, _, ps, kvh, hd = eng.cache.k.shape
            k = eng.cache.k.index_select(1, ids).reshape(n, -1, kvh, hd)[:, : sess.position]
            v = eng.cache.v.index_select(1, ids).reshape(n, -1, kvh, hd)[:, : sess.position]
            return k.cpu(), v.cpu()
        idx = eng.sessions[name]
        pos = eng.slots[idx].position
        return eng.cache.k_store[:, idx, :pos].cpu(), eng.cache.v_store[:, idx, :pos].cpu()

    async def turns(eng, park):
        a = await eng.chat("s", "turn one, with some length to it " * 3, max_tokens=9)
        before = kv(eng, "s")
        if park:
            blob = await eng.park_session("s")
            bk, bv, header = deserialize_kv_slot(blob)
            assert torch.equal(bk, before[0]) and torch.equal(bv, before[1])
            assert "s" not in eng.sessions and eng.has_session("s")
            assert await eng.prewarm_session("s") is True
            after = kv(eng, "s")
            assert torch.equal(after[0], before[0]) and torch.equal(after[1], before[1])
        b = await eng.chat("s", "turn two", max_tokens=9)
        return a["tokens"], b["tokens"]

    results = []
    for park in (False, True):
        eng = _graph_engine(kv_tiering=True, tier_quantize=0, paged_kv=paged, speculative=False)
        try:
            results.append(asyncio.run(turns(eng, park)))
            assert eng.worker_errors == 0, eng.last_worker_error
            if park:
                m = eng.metrics()
                assert m["tier_demotions_total"] == m["tier_promotions_total"] == 1
                assert {t["kind"] for t in eng.tier_timings} == {"park", "promote"}
        finally:
            eng.shutdown()
    assert results[0] == results[1]


# -- the training step -----------------------------------------------------------

# an unregistered config with a kernel-shaped head (head_dim 128) to train
TRAIN_HD128 = dict(
    name="test-train-hd128", vocab_size=320, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
    ffn_dim=512, max_seq_len=512, rope_theta=10_000.0,
)
GRAD_WRAPPERS = [
    "flash_prefill", "flash_decode", "fused_paged_flash_prefill", "fused_paged_flash_decode",
    "w8a16_matmul", "w8a16_grouped_matmul",
]


def _wrapper_case(name, dev):
    """A kernel wrapper, its first input (q, or x) and the rest of its
    arguments, at shapes its kernel takes."""
    from agentainer_tpu_torch.ops import cuda_quant

    g = torch.Generator(device=dev).manual_seed(21)
    if name.startswith("w8a16"):
        e = 4 if "grouped" in name else 1
        x, q, scale = _grouped_case(g, dev, e, 8, 256, 48, False)
        return getattr(cuda_quant, name), x, ((q, scale) if e > 1 else (q[0], scale[0]))
    decode = "decode" in name
    q = _randn(g, dev, torch.float32, *((1, 4, 128) if decode else (1, 8, 4, 128)))
    pos = torch.tensor([40] if decode else [list(range(8))], device=dev, dtype=torch.int32)
    if "paged" in name:
        pools = [_randn(g, dev, torch.float32, 4, 16, 2, 128) for _ in range(2)]
        table = torch.tensor([[2, 0, 3, 1]], device=dev, dtype=torch.int32)
        return getattr(ca, name), q, (*pools, table, pos)
    kv = [_randn(g, dev, torch.float32, 1, 64, 2, 128) for _ in range(2)]
    return getattr(ca, name), q, (*kv, pos)


@pytest.mark.parametrize("name", GRAD_WRAPPERS)
def test_train_kernel_wrappers_refuse_a_gradient_they_cannot_give(dev, name):
    """Under grad mode a card call with an input that requires grad raises,
    naming the wrapper and the differentiable path, and launches nothing;
    under ``no_grad`` the same call launches and returns a plain tensor."""
    fn, x, rest = _wrapper_case(name, dev)
    before = fn.launches
    with pytest.raises(RuntimeError, match=f"{name}: .*trainable_causal_attention"):
        fn(x.requires_grad_(), *rest)
    assert fn.launches == before
    with torch.no_grad():
        out = fn(x, *rest)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and out.grad_fn is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,kv_heads", [(4, 2), (32, 8)])
def test_train_attention_forward_is_the_kernel_and_backward_the_plain(dev, dtype, heads, kv_heads):
    """``trainable_causal_attention``: one prefill kernel launch forward,
    within the kernel tolerance of ``flash_prefill_plain``; none backward,
    whose dq/dk/dv are autograd through ``attention_reference`` on the same
    inputs (the same recomputation: f32 within 1e-6, bf16 within one bf16
    rounding of the gradients)."""
    from agentainer_tpu_torch.ops.attention import (
        attention_reference,
        causal_mask,
        trainable_causal_attention,
    )

    g = torch.Generator(device=dev).manual_seed(22)
    b, t = 2, 200
    q = _randn(g, dev, dtype, b, t, heads, 128).requires_grad_()
    k, v = (_randn(g, dev, dtype, b, t, kv_heads, 128).requires_grad_() for _ in range(2))
    go = _randn(g, dev, dtype, b, t, heads, 128)
    before = ca.flash_prefill.launches
    out = trainable_causal_attention(q, k, v)
    assert ca.flash_prefill.launches == before + 1 and out.grad_fn is not None
    pos = torch.arange(t, device=dev, dtype=torch.int32).expand(b, t)
    plain = ca.flash_prefill_plain(q.detach(), k.detach(), v.detach(), pos)
    torch.testing.assert_close(out.float(), plain.float(), rtol=TOL[dtype], atol=TOL[dtype])
    got = torch.autograd.grad(out, (q, k, v), go)
    assert ca.flash_prefill.launches == before + 1
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    ref = attention_reference(*leaves, mask=causal_mask(t, device=dev).expand(b, t, t))
    want = torch.autograd.grad(ref, leaves, go)
    rtol = 0.0 if dtype == torch.float32 else 2.0**-7
    for a, w in zip(got, want):
        torch.testing.assert_close(a.float(), w.float(), rtol=rtol, atol=1e-6)


def test_train_attention_refuses_a_head_the_kernel_does_not_take(dev):
    from agentainer_tpu_torch.ops.attention import trainable_causal_attention

    q = torch.zeros((1, 8, 4, 64), device=dev, requires_grad=True)
    k = torch.zeros((1, 8, 2, 64), device=dev)
    with pytest.raises(ValueError, match="unsupported shape"):
        trainable_causal_attention(q, k, k)


def test_train_forward_with_grad_raises_or_gives_the_plain_gradients(dev):
    """``forward`` with grad-requiring params on the card: the default
    kernel path raises; with ``attn_impl=trainable_causal_attention`` every
    leaf's gradient is the plain path's (``attn_impl=None``) within the
    repo's two-path f32 tolerance, 2e-4 of the leaf's largest gradient, and
    wq/wk/wv's are not zero."""
    from agentainer_tpu_torch.models.configs import ModelConfig
    from agentainer_tpu_torch.models.llama import forward, init_params
    from agentainer_tpu_torch.ops.attention import trainable_causal_attention
    from agentainer_tpu_torch.train import leaves

    cfg = ModelConfig(**TRAIN_HD128)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), torch.float32, dev)
    for p in leaves(params):
        p.requires_grad_(True)
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 96), generator=g, device=dev)
    pos = torch.arange(96, device=dev).expand(2, 96)
    w = torch.randn((2, 96, cfg.vocab_size), generator=g, device=dev)
    with pytest.raises(RuntimeError, match="flash_prefill"):
        forward(params, cfg, toks, pos)
    grads = []
    for impl in (trainable_causal_attention, None):
        logits = forward(params, cfg, toks, pos, use_flash=False, attn_impl=impl)
        grads.append(dict(zip(params["layers"], torch.autograd.grad(
            (logits * w).sum(), list(params["layers"].values())))))
    for name, want in grads[1].items():
        torch.testing.assert_close(grads[0][name], want, rtol=2e-4, atol=2e-4 * want.abs().max().item())
    assert all(grads[0][n].abs().max() > 0 for n in ("wq", "wk", "wv"))


def test_train_step_on_the_card_follows_the_cpu(dev):
    """``make_train_step`` on the card (its default device) and on the CPU
    from one param tree and batch: 3 losses within the two-path f32
    tolerance 2e-4, falling; n_layers prefill launches a step, no other
    kernel; the step count advanced."""
    import numpy as np

    from agentainer_tpu_torch.models.configs import ModelConfig
    from agentainer_tpu_torch.models.llama import init_params
    from agentainer_tpu_torch.ops import cuda_quant
    from agentainer_tpu_torch.train import make_train_step

    cfg = ModelConfig(**TRAIN_HD128)
    params = init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 129))
    others = (ca.flash_decode, ca.fused_paged_flash_prefill, ca.fused_paged_flash_decode,
              cuda_quant.w8a16_matmul, cuda_quant.w8a16_grouped_matmul)
    runs = {}
    for device in ("cpu", None):
        init_fn, step_fn, shard_batch = make_train_step(cfg, device=device)
        state = init_fn(params=params)  # a copy of the tree on each device
        batch = shard_batch(tokens)
        before = [ca.flash_prefill.launches] + [fn.launches for fn in others]
        losses = []
        for _ in range(3):
            state, loss = step_fn(state, batch)
            losses.append(loss.item())
        used = [ca.flash_prefill.launches - before[0]] + [fn.launches - n for fn, n in zip(others, before[1:])]
        runs[device] = losses
        assert state.step == 3 and batch.device.type == ("cpu" if device else "cuda")
        assert used == ([0] * 6 if device else [3 * cfg.n_layers] + [0] * 5), used
    np.testing.assert_allclose(runs[None], runs["cpu"], rtol=2e-4, atol=2e-4)
    assert runs[None][-1] < runs[None][0]


def test_train_step_refuses_a_head_the_kernel_does_not_take(dev):
    from agentainer_tpu_torch.models.configs import get_config
    from agentainer_tpu_torch.train import make_train_step

    with pytest.raises(ValueError, match="no attention kernel"):
        make_train_step(get_config("tiny"))
