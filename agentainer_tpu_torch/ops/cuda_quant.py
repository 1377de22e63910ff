"""int8-weight matrix product: a CUDA kernel for Hopper and its plain
PyTorch version.

Reference: no ``pallas_call``. The JAX package computes ``x @ dequant(w)``
(``agentainer_tpu/ops/quant.py``, ``agentainer_tpu/models/llama.py``) and
XLA fuses the int8 convert and the scale into the dot. ``w8a16_matmul`` is
that fusion on the card (``csrc/w8a16_gemm.cu``, note at the top): the int8
weight is read as stored and widened in registers, so no dense weight is
written to device memory.

- ``w8a16_matmul(x, q, scale)``: ``x [M, K]`` against one layer's ``q [K,
  N]`` int8 and ``scale [1, N]`` → ``[M, N]`` in x's dtype. On a CPU tensor
  it runs the plain version; on a CUDA tensor it launches the kernel (built
  by ``nvcc`` at first launch, ``ops/_build.py``) or raises — there is no
  fallback from the card to the plain version. It counts its calls in
  ``.launches``, or in ``.captured`` while its stream is being captured into
  a CUDA graph (``engine/graphs.py`` adds a graph's captured calls to
  ``.launches`` at every replay), as the attention wrappers do.
- ``w8a16_matmul_plain``: the same function in plain PyTorch, f32
  accumulation and one rounding at the end.
- ``plan(m, n, k)``: the kernel's token tile and contraction split for a
  shape, from the shape alone (so every bit of the result depends on the
  shape, never on the card or the data).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .cuda_attention import _count, _raise_on

BN = 128  # output channels per block
BK = 64  # contraction depth of one pipeline stage
BLOCK_MS = (16, 64, 128)  # token tiles the kernel instantiates
# Blocks a split aims for: two per SM of an H100 (132 SMs). A constant, not
# the card's count, so that the split (and the sum order) is the same
# everywhere.
TARGET_BLOCKS = 2 * 132
MIN_SPLIT_STEPS = 4  # contraction tiles a split covers at least
MAX_SPLITS = 16


def supported(k: int, n: int) -> bool:
    """Shapes the kernel takes: K a multiple of its 64-deep tile, N of 16
    (one 16-byte copy of int8 output channels)."""
    return k > 0 and n > 0 and k % BK == 0 and n % 16 == 0


def plan(m: int, n: int, k: int) -> tuple[int, int]:
    """(token tile, contraction splits) for ``[m, k] @ [k, n]``: the
    smallest tile that holds all m rows, the largest (128) beyond it — one
    widened weight fragment then feeds the most products
    (``scripts/torch_w8a16_sweep.py`` measured 128 rows fastest at m = 72
    and 256); the contraction split so that about ``TARGET_BLOCKS`` blocks
    run, each over at least ``MIN_SPLIT_STEPS`` tiles of it."""
    bm = next((b for b in BLOCK_MS if m <= b), BLOCK_MS[-1])
    tiles = -(-m // bm) * -(-n // BN)
    splits = min(TARGET_BLOCKS // max(1, tiles), (k // BK) // MIN_SPLIT_STEPS, MAX_SPLITS)
    return bm, max(1, splits)


def w8a16_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x [M, K] @ q [K, N]`` scaled per output channel, in f32, rounded
    once to x's dtype."""
    return ((x.float() @ q.float()) * scale.float()).to(x.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signature."""
    lib = _build.library("w8a16_gemm")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.atpu_w8a16_matmul.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, vp]
    lib.atpu_w8a16_matmul.restype = i32
    return lib


def _check_cuda(x, q, scale) -> None:
    tensors = {"x": x, "q": q, "scale": scale}
    for key, t in tensors.items():
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"w8a16_matmul: {key} must be on x's CUDA device, got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"w8a16_matmul: {key} must be contiguous and 16-byte aligned")
    if x.dtype != torch.bfloat16 or scale.dtype != torch.bfloat16 or q.dtype != torch.int8:
        raise ValueError(
            f"w8a16_matmul: takes bf16 x and scale and int8 q, got {x.dtype}, {scale.dtype}, {q.dtype}"
        )
    if x.dim() != 2 or q.dim() != 2 or x.shape[1] != q.shape[0]:
        raise ValueError(f"w8a16_matmul: x {tuple(x.shape)} and q {tuple(q.shape)} do not chain")
    k, n = q.shape
    if scale.numel() != n:
        raise ValueError(f"w8a16_matmul: scale {tuple(scale.shape)} for {n} output channels")
    if not supported(k, n):
        raise ValueError(f"w8a16_matmul: unsupported q [{k}, {n}] (K % {BK} == 0, N % 16 == 0)")


def w8a16_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x [M, K]`` times the int8 weight ``q [K, N]`` with its per-channel
    ``scale [1, N]``: ``[M, N]`` in x's dtype."""
    if x.device.type == "cpu":
        return w8a16_matmul_plain(x, q, scale)
    _check_cuda(x, q, scale)
    m = x.shape[0]
    k, n = q.shape
    bm, splits = plan(m, n, k)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    part = (
        torch.empty(splits * m * n, dtype=torch.float32, device=x.device) if splits > 1 else None
    )
    err = _lib().atpu_w8a16_matmul(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), m, n, k, bm, splits,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on(err, "w8a16_matmul")
    _count(w8a16_matmul)
    return out


w8a16_matmul.launches = 0
w8a16_matmul.captured = 0
