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
