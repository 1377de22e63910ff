"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is visible (CPU CI);
on the machine with the card run ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py`` (tests/conftest.py imports jax, which that
machine does not have). The kernels build from ``csrc/`` on first use.
Tolerances: f32 2e-5 with TF32 off (stated and set in the fixture), bf16
3e-2, as tests/test_pallas_attention.py holds the Pallas kernels.
"""

import pytest
import torch

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
