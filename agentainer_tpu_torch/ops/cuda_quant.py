"""int8-weight matrix product: a CUDA kernel for Hopper and its plain
PyTorch version.

Reference: no ``pallas_call``. The JAX package computes ``x @ dequant(w)``
(``agentainer_tpu/ops/quant.py``, ``agentainer_tpu/models/llama.py``) and
XLA fuses the int8 convert and the scale into the dot. ``w8a16_matmul`` is
that fusion on the card (``csrc/w8a16_gemm.cu``, note at the top): the int8
weight is read as stored by TMA and widened in registers into ``wgmma``, so
no dense weight is written to device memory.

- ``w8a16_matmul(x, q, scale)``: ``x [M, K]`` against one layer's ``q [K,
  N]`` int8 and ``scale [1, N]`` → ``[M, N]`` in x's dtype. On a CPU tensor
  it runs the plain version; on a CUDA tensor it launches the kernel once
  (built by ``nvcc`` at first launch, ``ops/_build.py``) or raises — there
  is no fallback from the card to the plain version. It counts its calls in
  ``.launches``, or in ``.captured`` while its stream is being captured into
  a CUDA graph (``engine/graphs.py`` adds a graph's captured calls to
  ``.launches`` at every replay), as the attention wrappers do; like them
  it raises under grad mode for an input that requires grad (the kernel
  has no backward).
- ``w8a16_matmul_plain``: the same function in plain PyTorch, f32
  accumulation and one rounding at the end (an expert stack too).
- ``w8a16_grouped_matmul(x, q, scale)``: every expert of a stack at once,
  the MoE layer's expert products. ``q [E, K, N]`` int8 with ``scale [E,
  1, N]`` against ``x [M, K]`` (one input for every expert: gate and up of
  the dense-einsum MoE) or ``x [E, M, K]`` (one per expert: down, and the
  routed path's dispatch buffers) → ``[E, M, N]``; the reference's expert
  einsums over a dequantized stack (``agentainer_tpu/models/llama.py:143-145,
  229-231``), which XLA fuses. One launch of ``w8a16_grouped_kernel``, the
  kernel that ``w8a16_matmul`` launches at E = 1, with the expert in
  ``blockIdx.z``; the plain version (``w8a16_matmul_plain``, which takes
  the stack too) on a CPU tensor; counted in its own ``.launches`` /
  ``.captured``.
- ``plan(m, n, k, e=1)``: the kernel's token tile and contraction split
  for a shape (``e`` experts of it in one launch), from the shape alone
  (so every bit of the result depends on the shape, never on the card or
  the data).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .cuda_attention import _count, _raise_on, refuse_grad

BN = 128  # output channels per block
BK = 64  # contraction depth of one pipeline stage
BLOCK_MS = (8, 24, 40, 72, 128, 256)  # token tiles the kernel instantiates (wgmma N)
# The splits of a column tile run as one thread-block cluster, and a block
# takes a whole SM, so a split count s fits one wave of an H100 while the
# tiles are at most the clusters of s blocks it runs at once
# (cudaOccupancyMaxActiveClusters on an H100 SXM, for every token tile:
# GPCs of 16-18 SMs; ``atpu_w8a16_max_clusters`` asks the card). Constants,
# not the card's numbers, so that the split (and the sum order) is the same
# everywhere.
CLUSTERS_PER_WAVE = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
MIN_SPLIT_STEPS = 4  # contraction tiles a split covers at least


def supported(k: int, n: int) -> bool:
    """Shapes the kernel takes: K a multiple of its 64-deep tile, N of 16
    (16-byte rows for TMA)."""
    return k > 0 and n > 0 and k % BK == 0 and n % 16 == 0


def _splits(tiles: int, k: int) -> int:
    """The most splits whose clusters still fit one wave
    (``CLUSTERS_PER_WAVE``) with each split over at least
    ``MIN_SPLIT_STEPS`` tiles of the contraction."""
    return max(
        s for s, fit in CLUSTERS_PER_WAVE.items()
        if s == 1 or (tiles <= fit and (k // BK) // s >= MIN_SPLIT_STEPS)
    )


@functools.cache
def plan(m: int, n: int, k: int, e: int = 1) -> tuple[int, int]:
    """(token tile, contraction splits) for ``[m, k] @ [k, n]``, done for
    ``e`` experts in one launch (``e`` times the tiles). Up to 128 rows,
    the smallest tile that holds them all. Beyond, 256 or 128 rows: 256
    widens each weight tile once for a whole prefill chunk, 128 makes twice
    the blocks, so 128 when its blocks fit one wave (``CLUSTERS_PER_WAVE[1]``)
    and are more than 256's or 256's do not fit. Then the most splits that
    fit (``_splits``)."""

    def tiles(bm):
        return e * -(-m // bm) * -(-n // BN)

    if m <= 128:
        bm = next(b for b in BLOCK_MS if m <= b)
    else:
        b256, b128 = (tiles(b) * _splits(tiles(b), k) for b in (256, 128))
        wave = CLUSTERS_PER_WAVE[1]
        bm = 128 if b128 <= wave and (b256 > wave or b128 > b256) else 256
    return bm, _splits(tiles(bm), k)


def w8a16_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x [M, K] @ q [K, N]`` scaled per output channel, in f32, rounded
    once to x's dtype. Also ``w8a16_grouped_matmul``'s: an expert stack ``q
    [E, K, N]`` with ``scale [E, 1, N]`` against ``x [M, K]`` or ``[E, M,
    K]`` gives ``[E, M, N]``."""
    return ((x.float() @ q.float()) * scale.float()).to(x.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures."""
    lib = _build.library("w8a16_gemm")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.atpu_w8a16_matmul.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, vp]
    lib.atpu_w8a16_matmul.restype = i32
    lib.atpu_w8a16_grouped_matmul.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, vp]
    lib.atpu_w8a16_grouped_matmul.restype = i32
    lib.atpu_w8a16_max_clusters.argtypes = [i32, i32]
    lib.atpu_w8a16_max_clusters.restype = i32
    return lib


def _check_cuda(x, q, scale, grouped: bool = False) -> None:
    """Raise unless the kernel takes these tensors: ``q`` one weight ``[K,
    N]`` and ``x [M, K]``, or (``grouped``) an expert stack ``[E, K, N]``
    and ``x [M, K]`` or ``[E, M, K]``."""
    name = "w8a16_grouped_matmul" if grouped else "w8a16_matmul"
    for key, t in (("x", x), ("q", q), ("scale", scale)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name}: {key} must be on x's CUDA device, got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be contiguous and 16-byte aligned")
    if x.dtype != torch.bfloat16 or scale.dtype != torch.bfloat16 or q.dtype != torch.int8:
        raise ValueError(
            f"{name}: takes bf16 x and scale and int8 q, got {x.dtype}, {scale.dtype}, {q.dtype}"
        )
    q_dims, x_dims = ((3,), (2, 3)) if grouped else ((2,), (2,))
    if (
        q.dim() not in q_dims or x.dim() not in x_dims or x.shape[-1] != q.shape[-2]
        or (x.dim() == 3 and x.shape[0] != q.shape[0])
    ):
        raise ValueError(f"{name}: x {tuple(x.shape)} and q {tuple(q.shape)} do not chain")
    k, n = q.shape[-2:]
    if scale.numel() != n * (q.shape[0] if grouped else 1):
        raise ValueError(f"{name}: scale {tuple(scale.shape)} for q {tuple(q.shape)}")
    if not supported(k, n):
        raise ValueError(f"{name}: unsupported q [{k}, {n}] (K % {BK} == 0, N % 16 == 0)")


def w8a16_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x [M, K]`` times the int8 weight ``q [K, N]`` with its per-channel
    ``scale [1, N]``: ``[M, N]`` in x's dtype."""
    if x.device.type == "cpu":
        return w8a16_matmul_plain(x, q, scale)
    refuse_grad("w8a16_matmul", x, scale)
    _check_cuda(x, q, scale)
    m = x.shape[0]
    k, n = q.shape
    bm, splits = plan(m, n, k)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = _lib().atpu_w8a16_matmul(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), m, n, k, bm, splits,
        torch._C._cuda_getCurrentRawStream(x.device.index),
    )
    _raise_on(err, "w8a16_matmul")
    _count(w8a16_matmul)
    return out


w8a16_matmul.launches = 0
w8a16_matmul.captured = 0


def w8a16_grouped_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Every expert's product in one launch: ``x [M, K]`` (shared) or ``[E,
    M, K]`` (per expert) times the int8 stack ``q [E, K, N]`` with its
    per-channel ``scale [E, 1, N]``: ``[E, M, N]`` in x's dtype."""
    if x.device.type == "cpu":
        return w8a16_matmul_plain(x, q, scale)
    refuse_grad("w8a16_grouped_matmul", x, scale)
    _check_cuda(x, q, scale, grouped=True)
    e, k, n = q.shape
    m = x.shape[-2]
    bm, splits = plan(m, n, k, e)
    out = torch.empty((e, m, n), dtype=x.dtype, device=x.device)
    err = _lib().atpu_w8a16_grouped_matmul(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), e, m, n, k, int(x.dim() == 3),
        bm, splits, torch._C._cuda_getCurrentRawStream(x.device.index),
    )
    _raise_on(err, "w8a16_grouped_matmul")
    _count(w8a16_grouped_matmul)
    return out


w8a16_grouped_matmul.launches = 0
w8a16_grouped_matmul.captured = 0
