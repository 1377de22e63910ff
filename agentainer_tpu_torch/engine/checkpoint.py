"""Checkpoint plane: model weights and KV-slot snapshots.

Reference: ``agentainer_tpu/engine/checkpoint.py`` — an own copy of
``SNAP_VERSION``, ``pack_kv_snapshot``, ``deserialize_kv_slot``,
``restore_kv_slot`` and ``load_params``:

- **weights**: ``load_params`` reads a HuggingFace checkpoint directory
  (``engine/hf_convert.py``). The reference's other layout, an orbax
  PyTree directory written by its ``save_params``, is refused with a
  ``ValueError``: the machine with the card has no orbax, and
  ``save_params`` is not ported;
- **KV snapshots**: one session's live KV prefix serialized to bytes for
  the store, so a restarted engine resumes the conversation without
  prefilling it again. The blob is the reference's, byte for byte in
  layout: an ``np.savez_compressed`` npz of ``k`` and ``v`` ``[L, position,
  KV, hd]`` in the arena's exact dtype (bf16 as uint16 bits, since npz has
  no bf16) and a JSON ``header`` (``version``, ``position``, ``dtype``, and
  the engine's ``session``, ``pending_token`` and, paged, ``page_size``).
  Blobs move between the JAX package and the port in both directions.

What differs from the reference: tensors are torch's. ``deserialize_kv_slot``
returns CPU tensors in the blob's true dtype (the machine with the card
has no ``ml_dtypes``), and ``restore_kv_slot`` writes into the arena's
existing tensors in place instead of returning a new cache, because the
engine's step graphs replay those tensors' addresses.
"""

from __future__ import annotations

import io
import json
from pathlib import Path

import numpy as np
import torch

from ..models.configs import ModelConfig
from ..models.llama import KVCache
from .hf_convert import is_hf_checkpoint, load_hf_params

# v1: fp16 payload; v2: the arena's exact dtype; v3: the paged-arena era,
# same payload (a paged engine gathers the session's live pages into it)
# plus an optional ``page_size`` header. All three restore.
SNAP_VERSION = 3


def load_params(
    cfg: ModelConfig,
    path: str | Path,
    dtype=torch.bfloat16,
    device="cpu",
    stats: dict | None = None,
    quant: str = "",
) -> dict:
    """Weights from a HuggingFace checkpoint directory (``config.json`` +
    ``*.safetensors``) on ``device`` in ``dtype``; any other layout
    raises. ``quant="int8"`` quantizes the matmul weights as they stream
    (the reference's ``quantize_params(load_params(...))``, bit for bit).
    ``stats`` receives the load's ``bytes_read`` and ``seconds``."""
    path = Path(path).expanduser().resolve()
    if is_hf_checkpoint(path):
        return load_hf_params(cfg, path, dtype, device, stats, quant)
    raise ValueError(
        f"{path}: not a HuggingFace checkpoint (no *.safetensors). The reference's other "
        "layout, an orbax PyTree directory, is not read by the PyTorch port"
    )


def _host_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host tensor as numpy, and its dtype's name (bf16 as uint16 bits)."""
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def pack_kv_snapshot(k: torch.Tensor, v: torch.Tensor, position: int, meta: dict | None = None) -> bytes:
    """Host half of a KV snapshot: trim the staged host tensors ``[L, n,
    KV, hd]`` (n >= position) to the live prefix and pack the npz blob.
    Only the written prefix ships."""
    k_np, dtype_name = _host_numpy(k[:, :position])
    v_np, _ = _host_numpy(v[:, :position])
    header = json.dumps({"version": SNAP_VERSION, "position": position, "dtype": dtype_name, **(meta or {})})
    buf = io.BytesIO()
    np.savez_compressed(buf, k=k_np, v=v_np, header=np.frombuffer(header.encode(), dtype=np.uint8))
    return buf.getvalue()


def deserialize_kv_slot(blob: bytes) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """(k [L, position, KV, hd], v, header) as CPU tensors in the
    snapshot's true dtype. Accepts v1 (fp16 payload), v2 and v3 blobs;
    raises ``ValueError`` on another version or a malformed payload."""
    with np.load(io.BytesIO(blob)) as z:
        header = json.loads(bytes(z["header"]).decode())
        k, v = z["k"], z["v"]
    version = header.get("version")
    if version not in (1, 2, SNAP_VERSION):
        raise ValueError(f"unsupported KV snapshot version: {version}")
    if k.ndim != 4 or k.shape != v.shape or k.shape[1] != header.get("position"):
        raise ValueError(
            f"malformed KV snapshot: k {k.shape}, v {v.shape}, position {header.get('position')}"
        )
    if version != 1 and header.get("dtype") == "bfloat16":
        return (
            torch.from_numpy(k.view(np.int16)).view(torch.bfloat16),
            torch.from_numpy(v.view(np.int16)).view(torch.bfloat16),
            header,
        )
    return torch.from_numpy(k), torch.from_numpy(v), header


def restore_kv_slot(cache: KVCache, slot: int, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write a snapshot into arena row ``slot``'s prefix, in place; the rest
    of the arena is unchanged. ``k``/``v`` must already be in the arena's
    dtype; on the card they are pinned host tensors and the copy does not
    wait for the stream. A mesh's ``MeshCache`` takes the unsharded layout
    and writes each shard its kv heads."""
    cache.write_prefix(slot, k, v)
