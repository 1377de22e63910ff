"""HuggingFace checkpoint → engine params.

Reference: ``agentainer_tpu/engine/hf_convert.py`` — an own copy of
``is_hf_checkpoint``, ``config_from_hf`` and ``load_hf_params`` with the
reference's name mapping. A HF Llama / Mixtral directory (``config.json``
and ``*.safetensors``, one file or sharded under
``model.safetensors.index.json``) maps onto the port's parameter tree
(``models/llama.py``): HF stores projections as ``[out, in]`` Linear
weights and the port computes ``x @ W``, so every projection is
transposed; the RoPE layout is HF's own, so q/k need no permutation.

    model.embed_tokens.weight            → embed                [V, D]
    …layers.{i}.input_layernorm.weight   → layers.attn_norm[i]  [D]
    …layers.{i}.self_attn.{q,k,v}_proj   → wq/wk/wv[i]          [D, H*hd]ᵀ
    …layers.{i}.self_attn.o_proj         → wo[i]                [H*hd, D]ᵀ
    …layers.{i}.post_attention_layernorm → layers.mlp_norm[i]   [D]
    …layers.{i}.mlp.{gate,up,down}_proj  → w_gate/w_up/w_down   ᵀ
    model.norm.weight                    → final_norm           [D]
    lm_head.weight (or tied embeddings)  → lm_head              [D, V]ᵀ

Mixtral MoE:
    …block_sparse_moe.gate               → router[i]            [D, E]ᵀ
    …experts.{e}.w1 / w3 / w2            → w_gate/w_up/w_down[i,e]ᵀ

What differs from the reference, and why:

- the safetensors format is read with the standard library and numpy
  (``SafetensorsFile``): the machine with the card has no ``safetensors``
  package. Its header, the shard index and ``config_from_hf`` live in
  ``engine/safetensors_meta.py``, which imports neither torch nor numpy,
  so the daemon's artifact registry validates a directory with the same
  parser; ``BF16`` (viewed through uint16), ``F16`` and ``F32`` data are
  read, any other dtype raises naming it;
- the load streams: the tree is allocated once on the target device and
  each tensor goes from a ``np.memmap`` of its file, in row blocks of at
  most ``_STREAM_BYTES``, through a staging buffer (pinned on the card) to
  the device, where it is cast and transposed into its leaf. The host
  holds one block at a time, never a stacked layer tensor (the reference
  stacks and transposes on the host, then hands the engine host arrays);
- with ``quant="int8"`` each matmul weight is quantized on the device one
  layer slice at a time, right after the slice lands and is transposed
  there (``ops/quant.quantize_array``'s arithmetic): the dense model never
  exists whole on the device, and the result equals the reference's
  ``quantize_params(load_params(...))`` bit for bit. Tied embeddings
  quantize ``lm_head`` from the dense ``embed.t()`` before ``embed``
  itself is quantized.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import numpy as np
import torch

from ..models.configs import ModelConfig
from ..ops.quant import QTensor, quantize_array, quantize_into
from .quant import QUANT_SCHEMES
from .safetensors_meta import (  # noqa: F401  (config_from_hf, is_hf_checkpoint: this module's API)
    SafetensorsHeader,
    config_from_hf,
    is_hf_checkpoint,
    open_shards,
)

# safetensors dtype → (raw little-endian numpy dtype, torch dtype)
_DTYPES = {
    "BF16": (np.dtype("<u2"), torch.bfloat16),
    "F16": (np.dtype("<f2"), torch.float16),
    "F32": (np.dtype("<f4"), torch.float32),
}
# bytes of one streamed block: the staging buffers' size
_STREAM_BYTES = 64 << 20


class SafetensorsFile(SafetensorsHeader):
    """One ``.safetensors`` file: its header parsed (``safetensors_meta``),
    its tensors mapped read-only from disk on demand (``array``)."""

    def dtype(self, name: str) -> torch.dtype:
        return _dtype(self.path, name, self.header[name]["dtype"])[1]

    def array(self, name: str) -> np.ndarray:
        """The tensor as a read-only memory map in its stored dtype (bf16 as
        uint16 bits)."""
        entry = self.header[name]
        raw, _ = _dtype(self.path, name, entry["dtype"])
        shape = tuple(entry["shape"])
        start, end = entry["data_offsets"]
        if end - start != int(np.prod(shape, dtype=np.int64)) * raw.itemsize:
            raise ValueError(f"{self.path}: {name}: data_offsets {start}..{end} do not hold {shape}")
        if end == start:
            return np.zeros(shape, dtype=raw)
        return np.memmap(self.path, dtype=raw, mode="r", offset=self._data_start + start, shape=shape)


def _dtype(path: Path, name: str, tag: str):
    try:
        return _DTYPES[tag]
    except KeyError:
        raise ValueError(
            f"{path}: {name} is stored as {tag}; the reader takes {', '.join(_DTYPES)}"
        ) from None


def _open_shards(path: Path) -> dict[str, SafetensorsFile]:
    """name → its file. Handles single-file and index-sharded layouts."""
    return open_shards(path, SafetensorsFile)


class _Streamer:
    """Copies checkpoint tensors into device leaves in row blocks. On the
    card a block is staged in one of two pinned buffers and copied to the
    device without waiting; a buffer is refilled only after the event of
    its last copy has landed, so reading the next block from disk overlaps
    the copy of the one before."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self._bufs: list[torch.Tensor | None] = [None, None]
        self._events: list = [None, None]
        self._turn = 0
        self.bytes_read = 0

    def _to_device(self, block: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        """``block`` (read from disk here) as a tensor of ``dtype`` on the
        device; on the card its copy is in flight on the current stream."""
        if not self.cuda:
            host = np.array(block)  # the disk read; a writable copy
            if dtype == torch.bfloat16:
                return torch.from_numpy(host.view(np.int16)).view(torch.bfloat16)
            return torch.from_numpy(host)
        i, self._turn = self._turn, 1 - self._turn
        if self._events[i] is not None:
            self._events[i].synchronize()
        buf = self._bufs[i]
        if buf is None or buf.numel() < block.nbytes:
            buf = self._bufs[i] = torch.empty(
                max(_STREAM_BYTES, block.nbytes), dtype=torch.uint8, pin_memory=True
            )
        staged = buf[: block.nbytes]
        np.copyto(staged.numpy().view(block.dtype).reshape(block.shape), block)
        part = staged.view(dtype).reshape(block.shape).to(self.device, non_blocking=True)
        self._events[i] = torch.cuda.Event()
        self._events[i].record()
        return part

    def copy(self, dst: torch.Tensor, src: np.ndarray, dtype: torch.dtype, transpose: bool) -> None:
        """``dst`` ← ``src`` (transposed: ``dst`` is ``[in, out]`` and
        ``src`` ``[out, in]``), cast to ``dst``'s dtype on the device."""
        want = tuple(dst.shape[::-1]) if transpose else tuple(dst.shape)
        if tuple(src.shape) != want:
            raise ValueError(f"checkpoint tensor of shape {tuple(src.shape)}, expected {want}")
        rows = src.shape[0]
        row_bytes = max(1, src.nbytes // max(1, rows))
        step = max(1, _STREAM_BYTES // row_bytes)
        for r0 in range(0, rows, step):
            block = src[r0 : r0 + step]
            part = self._to_device(block, dtype)
            if transpose:
                dst[:, r0 : r0 + block.shape[0]].copy_(part.t())
            else:
                dst[r0 : r0 + block.shape[0]].copy_(part)
            self.bytes_read += block.nbytes


def load_hf_params(
    cfg: ModelConfig,
    path: str | Path,
    dtype: torch.dtype = torch.bfloat16,
    device="cpu",
    stats: dict | None = None,
    quant: str = "",
) -> dict:
    """Map a HF Llama/Mixtral checkpoint directory onto the port's
    parameter tree on ``device`` in ``dtype``, streamed tensor by tensor
    (``quant="int8"``: the matmul weights as int8 ``QTensor``s, quantized
    slice by slice as they land). ``stats``, when given, receives
    ``bytes_read`` and ``seconds``."""
    if quant and quant not in QUANT_SCHEMES:
        raise ValueError(f"unknown quant scheme {quant!r} (supported: {', '.join(QUANT_SCHEMES)})")
    t0 = time.perf_counter()
    p = Path(path).expanduser().resolve()
    files = _open_shards(p)
    dev = torch.device(device)
    d, hd, L = cfg.dim, cfg.head_dim, cfg.n_layers

    def empty(*shape):
        return torch.empty(shape, dtype=dtype, device=dev)

    def weight(*shape):
        """A matmul leaf: dense, or int8 with its per-channel scale."""
        if not quant:
            return empty(*shape)
        return QTensor(
            torch.empty(shape, dtype=torch.int8, device=dev),
            empty(*shape[:-2], 1, shape[-1]),
        )

    layers = {
        "attn_norm": empty(L, d),
        "wq": weight(L, d, cfg.n_heads * hd),
        "wk": weight(L, d, cfg.n_kv_heads * hd),
        "wv": weight(L, d, cfg.n_kv_heads * hd),
        "wo": weight(L, cfg.n_heads * hd, d),
        "mlp_norm": empty(L, d),
    }
    ffn = (L, cfg.n_experts) if cfg.is_moe else (L,)
    layers["w_gate"] = weight(*ffn, d, cfg.ffn_dim)
    layers["w_up"] = weight(*ffn, d, cfg.ffn_dim)
    layers["w_down"] = weight(*ffn, cfg.ffn_dim, d)
    if cfg.is_moe:
        layers["router"] = weight(L, d, cfg.n_experts)
    params = {
        # dense while it loads (a tied lm_head is its transpose); quantized last
        "embed": empty(cfg.vocab_size, d),
        "layers": layers,
        "final_norm": empty(d),
        "lm_head": weight(d, cfg.vocab_size),
    }
    staging: dict[tuple, torch.Tensor] = {}  # one dense slice per shape (quant)

    st = _Streamer(dev)

    def load(dst, name: str, transpose: bool) -> None:
        """``dst``: a dense leaf (or slice), or a ``(q, scale)`` slice of
        an int8 leaf, filled through a dense staging slice."""
        if name not in files:
            raise ValueError(f"{p}: the checkpoint has no tensor {name}")
        f = files[name]
        dense = dst
        if isinstance(dst, tuple):
            shape = tuple(dst[0].shape)
            dense = staging.get(shape)
            if dense is None:
                dense = staging[shape] = empty(*shape)
        try:
            st.copy(dense, f.array(name), f.dtype(name), transpose)
        except ValueError as e:
            raise ValueError(f"{p}: {name}: {e}") from None
        if isinstance(dst, tuple):
            quantize_into(dense, *dst)

    def at(leaf, *index):
        """The slice ``index`` of a leaf: a view, or (q, scale) views."""
        if isinstance(leaf, QTensor):
            return (leaf.q[index], leaf.scale[index])
        return leaf[index]

    ctx = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
    with ctx, torch.no_grad():
        load(params["embed"], "model.embed_tokens.weight", False)
        for i in range(L):
            pre = f"model.layers.{i}."
            load(layers["attn_norm"][i], pre + "input_layernorm.weight", False)
            load(layers["mlp_norm"][i], pre + "post_attention_layernorm.weight", False)
            for leaf, proj in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"), ("wo", "o_proj")):
                load(at(layers[leaf], i), pre + f"self_attn.{proj}.weight", True)
            if cfg.is_moe:
                load(at(layers["router"], i), pre + "block_sparse_moe.gate.weight", True)
                for e in range(cfg.n_experts):
                    ex = pre + f"block_sparse_moe.experts.{e}."
                    for leaf, w in (("w_gate", "w1"), ("w_down", "w2"), ("w_up", "w3")):
                        load(at(layers[leaf], i, e), ex + w + ".weight", True)
            else:
                for leaf, proj in (("w_gate", "gate_proj"), ("w_up", "up_proj"), ("w_down", "down_proj")):
                    load(at(layers[leaf], i), pre + f"mlp.{proj}.weight", True)
        load(params["final_norm"], "model.norm.weight", False)
        if "lm_head.weight" in files:
            load(at(params["lm_head"]), "lm_head.weight", True)
        elif quant:  # tied embeddings, quantized from the dense transpose
            quantize_into(params["embed"].t(), *at(params["lm_head"]))
        else:  # tied embeddings
            params["lm_head"].copy_(params["embed"].t())
        staging.clear()
        if quant:
            params["embed"] = quantize_array(params["embed"], dtype)
        if dev.type == "cuda":
            # the engine's own stream reads these leaves: they must have landed
            torch.cuda.synchronize(dev)
    if stats is not None:
        stats.update(bytes_read=st.bytes_read, seconds=time.perf_counter() - t0)
    return params

