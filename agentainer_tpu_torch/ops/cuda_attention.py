"""Flash attention over the KV arena: CUDA kernels for Hopper and their
plain PyTorch versions.

Reference: ``agentainer_tpu/ops/pallas_attention.py`` — ``flash_prefill``
(``_prefill_kernel``), ``flash_decode`` (``_decode_kernel``),
``fused_paged_flash_prefill`` (``_paged_prefill_kernel``),
``fused_paged_flash_decode`` (``_paged_decode_kernel``), ``kernel_supported``
and ``flash_attention_tpu``.

Every function here takes the reference's layout: q ``[B, T, H, hd]`` (or
``[B, H, hd]`` for decode), the dense arena k/v ``[B, S, KV, hd]`` or the
page pools ``[P, page_size, KV, hd]`` with a block table ``[B, n_blocks]``
(logical slot ``j`` of lane ``b`` is row ``j % page_size`` of page
``table[b, j // page_size]``, ``S = n_blocks * page_size``), and per-row int
positions. Row ``pos`` sees slot ``j`` iff ``j <= pos`` and ``j < S``;
scores and softmax are f32; a row that sees no slot (``pos < 0``) returns
zeros; the output has q's dtype.

- ``flash_prefill`` / ``flash_decode`` / ``fused_paged_flash_prefill`` /
  ``fused_paged_flash_decode`` are the wrappers. On a CPU tensor they run
  the plain version; on a CUDA tensor they launch the hand-written kernel in
  ``csrc/flash_attention.cu`` (built by ``nvcc`` at first launch,
  ``ops/_build.py``) or raise — there is no fallback from the card to the
  plain version. Each wrapper counts its kernel launches in ``.launches``.
- The decode kernels split the KV axis: ``flash_decode`` and
  ``fused_paged_flash_decode`` launch two kernels per call, one block per
  (kv head, lane, split of ``DECODE_SPLIT`` slots) writing f32 partials to
  scratch the wrapper allocates, then a combine that merges the splits in
  fixed order. ``.launches`` counts wrapper calls.
- ``*_plain`` compute the same functions in plain PyTorch (the paged ones
  gather the lane's pages into a dense view first): the CPU tests hold them
  against the JAX kernels, and the card's check holds the kernels against
  them.

The reference gates its fused paged kernels on ``page_size % 8 == 0`` (its
sublane tiling) and gathers into a dense view otherwise. These kernels look
the page up for every 16-byte load, so they take any page size and need no
such gate or second branch.

The kernels read q, the arena and the pools in place through their strides
(the engine's arena rows are strided views); head_dim must be contiguous and
every other stride a multiple of 16 bytes, since the kernels load 16 bytes
per thread.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

NEG_INF = -1e30
HEAD_DIM = 128  # the one head_dim the kernels are written for
_GROUPS = (1, 2, 4, 8, 16)  # query heads per kv head the kernels instantiate
# Slots per decode split: a multiple of the kernels' 64-slot tile, fixed here
# so that the split (and so every bit of the result) depends on S alone, not
# on the positions, the page size or the arena policy.
DECODE_SPLIT = 256


def kernel_supported(n_heads: int, n_kv_heads: int, head_dim: int) -> bool:
    """The kernels assume head_dim 128 and a clean GQA grouping of 1-16
    query heads per kv head (the reference admits head_dim % 128 == 0;
    every registered config with a kernel-shaped head has exactly 128)."""
    return (
        head_dim == HEAD_DIM
        and n_heads % n_kv_heads == 0
        and n_heads // n_kv_heads in _GROUPS
    )


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _attend_plain(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor):
    """qg [B, T, KV, G, hd], k/v [B, S, KV, hd], pos [B, T] → f32
    [B, T, KV, G, hd] under the kernels' masking and l == 0 rules."""
    s_len = k.shape[1]
    scale = 1.0 / (qg.shape[-1] ** 0.5)
    scores = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) * scale
    slots = torch.arange(s_len, device=pos.device)
    visible = (slots[None, None, :] <= pos[:, :, None].long())[:, None, None]  # [B,1,1,T,S]
    scores = torch.where(visible, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(visible, torch.exp(scores - m), torch.zeros_like(scores))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    l = torch.where(l == 0, torch.ones_like(l), l)  # no visible slot: zeros
    return out / l.permute(0, 3, 1, 2, 4)


def flash_prefill_plain(q, k, v, q_positions) -> torch.Tensor:
    """Plain PyTorch ``flash_prefill``: q [B, T, H, hd] → [B, T, H, hd]."""
    b, t, h, hd = q.shape
    kv = k.shape[2]
    out = _attend_plain(q.reshape(b, t, kv, h // kv, hd), k, v, q_positions)
    return out.reshape(b, t, h, hd).to(q.dtype)


def flash_decode_plain(q, k, v, q_positions) -> torch.Tensor:
    """Plain PyTorch ``flash_decode``: q [B, H, hd] → [B, H, hd]."""
    b, h, hd = q.shape
    kv = k.shape[2]
    out = _attend_plain(q.reshape(b, 1, kv, h // kv, hd), k, v, q_positions[:, None])
    return out.reshape(b, h, hd).to(q.dtype)


def paged_flash_prefill_plain(q, pool_k, pool_v, block_table, q_positions) -> torch.Tensor:
    """Plain PyTorch ``fused_paged_flash_prefill``: gather the lanes' pages
    into dense views, then ``flash_prefill_plain``."""
    from .attention import gather_pages  # deferred: attention.py imports this module

    k, v = gather_pages(pool_k, pool_v, block_table)
    return flash_prefill_plain(q, k, v, q_positions)


def paged_flash_decode_plain(q, pool_k, pool_v, block_table, q_positions) -> torch.Tensor:
    """Plain PyTorch ``fused_paged_flash_decode``."""
    from .attention import gather_pages

    k, v = gather_pages(pool_k, pool_v, block_table)
    return flash_decode_plain(q, k, v, q_positions)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures."""
    lib = _build.library("flash_attention")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    strides = ctypes.POINTER(ctypes.c_longlong)
    # every pointer and the stream as c_void_p: without argtypes ctypes
    # passes Python ints as 32-bit C ints and cuts the pointers
    lib.atpu_flash_prefill.argtypes = [
        vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, strides, ctypes.c_float, vp,
    ]
    lib.atpu_flash_prefill.restype = i32
    lib.atpu_flash_decode.argtypes = [
        vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, strides, ctypes.c_float, vp,
    ]
    lib.atpu_flash_decode.restype = i32
    lib.atpu_paged_flash_prefill.argtypes = [
        vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, strides, ctypes.c_float, vp,
    ]
    lib.atpu_paged_flash_prefill.restype = i32
    lib.atpu_paged_flash_decode.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, strides, ctypes.c_float,
        vp,
    ]
    lib.atpu_paged_flash_decode.restype = i32
    return lib


@functools.cache
def _decode_part_floats() -> int:
    """f32 values of one (lane, head, split) partial (the library owns their
    layout: acc[hd], m, l)."""
    return _lib().atpu_decode_part_floats()


def _check_cuda(name: str, q, k, v, positions, table=None) -> None:
    """What the kernels take: everything on q's CUDA device, one dtype for
    q/k/v, int32 positions, a kernel-shaped head, 16-byte aligned strides;
    for the paged kernels k/v are the pools and ``table`` an int32
    ``[B, n_blocks]`` block table, contiguous in its last axis."""
    if not kernel_supported(q.shape[-2], k.shape[2], q.shape[-1]) or k.shape[-1] != HEAD_DIM:
        raise ValueError(
            f"{name}: unsupported shape q {tuple(q.shape)} k {tuple(k.shape)} "
            f"(head_dim {HEAD_DIM}, query heads per kv head in {_GROUPS})"
        )
    tensors = {"q": q, "k": k, "v": v, "positions": positions}
    if table is not None:
        tensors["block_table"] = table
        if table.dtype != torch.int32 or table.dim() != 2 or table.shape[0] != q.shape[0]:
            raise ValueError(
                f"{name}: block_table must be int32 [B, n_blocks], got "
                f"{table.dtype} {tuple(table.shape)}"
            )
        if table.stride(-1) != 1:
            raise ValueError(f"{name}: block_table must be contiguous in its last axis")
    for key, x in tensors.items():
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{name}: {key} must be on q's CUDA device, got {x.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q/k/v must share one dtype of {list(_DTYPES)}")
    if positions.dtype != torch.int32:
        raise ValueError(f"{name}: positions must be int32, got {positions.dtype}")
    if k.shape != v.shape:
        raise ValueError(f"{name}: k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    esize = q.element_size()
    for key in ("q", "k", "v"):
        x = tensors[key]
        if x.stride(-1) != 1:
            raise ValueError(f"{name}: {key} head_dim must be contiguous")
        if x.data_ptr() % 16 or any((s * esize) % 16 for s in x.stride()[:-1]):
            raise ValueError(f"{name}: {key} must be 16-byte aligned in every stride")


def _strides(*tensors_and_dims) -> ctypes.Array:
    vals = [t.stride(d) for t, dims in tensors_and_dims for d in dims]
    return (ctypes.c_longlong * len(vals))(*vals)


def _decode_scratch(q, s_len: int) -> torch.Tensor:
    """f32 partials of every (lane, head, split) that the split kernel
    writes and the combine reads."""
    b, h, _ = q.shape
    n_split = -(-s_len // DECODE_SPLIT)
    size = b * h * n_split * _decode_part_floats()
    return torch.empty(size, dtype=torch.float32, device=q.device)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


def flash_prefill(q, k, v, q_positions) -> torch.Tensor:
    """Ragged cached causal GQA attention: q [B, T, H, hd] over the arena
    k/v [B, S, KV, hd]; row t sees slot j iff j <= q_positions[b, t]."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, q_positions)
    _check_cuda("flash_prefill", q, k, v, q_positions)
    b, t, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    st = _strides(
        (q, (0, 1, 2)), (k, (0, 1, 2)), (v, (0, 1, 2)), (q_positions, (0, 1)), (out, (0, 1, 2))
    )
    err = _lib().atpu_flash_prefill(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], b, t, h, kv, s, st, 1.0 / hd**0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "flash_prefill")
    flash_prefill.launches += 1
    return out


flash_prefill.launches = 0


def flash_decode(q, k, v, q_positions) -> torch.Tensor:
    """Single-token GQA attention: q [B, H, hd] over the arena k/v
    [B, S, KV, hd]; lane b sees slot j iff j <= q_positions[b]."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, q_positions)
    _check_cuda("flash_decode", q, k, v, q_positions)
    b, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    st = _strides((q, (0, 1)), (k, (0, 1, 2)), (v, (0, 1, 2)), (q_positions, (0,)), (out, (0, 1)))
    scratch = _decode_scratch(q, s)
    err = _lib().atpu_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), _DTYPES[q.dtype], b, h, kv, s, DECODE_SPLIT, st, 1.0 / hd**0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def fused_paged_flash_prefill(q, pool_k, pool_v, block_table, q_positions) -> torch.Tensor:
    """``flash_prefill`` over a paged arena: q [B, T, H, hd] against the
    pools [P, ps, KV, hd] through the block table [B, n_blocks], with no
    gathered arena in between."""
    if q.device.type == "cpu":
        return paged_flash_prefill_plain(q, pool_k, pool_v, block_table, q_positions)
    _check_cuda("fused_paged_flash_prefill", q, pool_k, pool_v, q_positions, block_table)
    b, t, h, hd = q.shape
    ps, kv = pool_k.shape[1], pool_k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    st = _strides(
        (q, (0, 1, 2)), (pool_k, (0, 1, 2)), (pool_v, (0, 1, 2)), (q_positions, (0, 1)),
        (out, (0, 1, 2)), (block_table, (0,)),
    )
    err = _lib().atpu_paged_flash_prefill(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), block_table.data_ptr(),
        q_positions.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], b, t, h, kv, ps,
        block_table.shape[1], st, 1.0 / hd**0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "fused_paged_flash_prefill")
    fused_paged_flash_prefill.launches += 1
    return out


fused_paged_flash_prefill.launches = 0


def fused_paged_flash_decode(q, pool_k, pool_v, block_table, q_positions) -> torch.Tensor:
    """``flash_decode`` over a paged arena: q [B, H, hd]; pages past each
    lane's position are never loaded."""
    if q.device.type == "cpu":
        return paged_flash_decode_plain(q, pool_k, pool_v, block_table, q_positions)
    _check_cuda("fused_paged_flash_decode", q, pool_k, pool_v, q_positions, block_table)
    b, h, hd = q.shape
    ps, kv = pool_k.shape[1], pool_k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    st = _strides(
        (q, (0, 1)), (pool_k, (0, 1, 2)), (pool_v, (0, 1, 2)), (q_positions, (0,)),
        (out, (0, 1)), (block_table, (0,)),
    )
    scratch = _decode_scratch(q, ps * block_table.shape[1])
    err = _lib().atpu_paged_flash_decode(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), block_table.data_ptr(),
        q_positions.data_ptr(), out.data_ptr(), scratch.data_ptr(), _DTYPES[q.dtype], b, h, kv,
        ps, block_table.shape[1], DECODE_SPLIT, st, 1.0 / hd**0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "fused_paged_flash_decode")
    fused_paged_flash_decode.launches += 1
    return out


fused_paged_flash_decode.launches = 0


def flash_attention_causal(q, k, v) -> torch.Tensor:
    """Causal self-attention without an arena (reference:
    ``flash_attention_tpu``): ``flash_prefill`` with positions = arange(T)."""
    b, t = q.shape[0], q.shape[1]
    positions = torch.arange(t, dtype=torch.int32, device=q.device).expand(b, t)
    return flash_prefill(q, k, v, positions)
